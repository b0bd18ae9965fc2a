"""The port's text stages against their JAX twins on the CPU: Tokenizer,
RegexTokenizer, StopWordsRemover, NGram, HashingTF, FeatureHasher and
CountVectorizer / CountVectorizerModel, on the same seeded frames, with the
params the JAX package's own tests exercise (``tests/test_feature_stateless.py``,
``tests/test_feature_fitted.py``) and their edges; saved directories loaded
across both packages.

Token lists, vocabularies and the indices of every sparse output are held
exactly; the values too — counts and hashed sums come from the same
bit-exact combine (``tests/test_torch_entries.py``), so nothing here needs
the 1e-6 the port allows itself for values.
"""
import numpy as np
import pytest
import torch

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.models.feature.count_vectorizer import (
    CountVectorizer as JCountVectorizer,
    CountVectorizerModel as JCountVectorizerModel,
)
from flink_ml_tpu.models.feature.feature_hasher import FeatureHasher as JFeatureHasher
from flink_ml_tpu.models.feature.hashing_tf import HashingTF as JHashingTF
from flink_ml_tpu.models.feature.ngram import NGram as JNGram
from flink_ml_tpu.models.feature.stop_words_remover import StopWordsRemover as JStopWordsRemover
from flink_ml_tpu.models.feature.tokenizer import RegexTokenizer as JRegexTokenizer
from flink_ml_tpu.models.feature.tokenizer import Tokenizer as JTokenizer
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.models.feature import (
    CountVectorizer,
    CountVectorizerModel,
    FeatureHasher,
    HashingTF,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from flink_ml_tpu_torch.utils import read_write as rw

torch.set_num_threads(1)

TWINS = {
    Tokenizer: JTokenizer, RegexTokenizer: JRegexTokenizer, StopWordsRemover: JStopWordsRemover,
    NGram: JNGram, HashingTF: JHashingTF, FeatureHasher: JFeatureHasher,
    CountVectorizer: JCountVectorizer, CountVectorizerModel: JCountVectorizerModel,
}
WORDS = ["alpha", "Beta", "the", "a", "of", "IS", "gamma", "δέλτα", "I", "İstanbul", "😀x", ""]


def _pair(stage, **params):
    """The port stage with ``params`` set, and its JAX twin with the same
    param map."""
    for name, value in params.items():
        setter = getattr(stage, f"set_{name}")
        setter(*value) if isinstance(value, tuple) else setter(value)
    twin = TWINS[type(stage)]()
    twin.load_param_map_from_json(stage.param_map_to_json())
    return stage, twin


def _frames(columns):
    return DataFrame.from_dict(columns), JDataFrame.from_dict(columns)


def _run(stage, twin, columns):
    df, jdf = _frames(columns)
    return stage.transform(df, device="cpu"), twin.transform(jdf)


def _same_column(got, want, where):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        if hasattr(w, "indices"):
            assert g.size() == w.size(), (where, i)
            np.testing.assert_array_equal(g.indices, w.indices, err_msg=f"{where} row {i}")
            np.testing.assert_array_equal(g.values, w.values, err_msg=f"{where} row {i}")
        else:
            assert list(g) == list(w), (where, i, g, w)


def _documents(seed, n, max_len=12, words=WORDS):
    rng = np.random.default_rng(seed)
    return [[words[i] for i in rng.integers(0, len(words), k)] for k in rng.integers(0, max_len + 1, n)]


def _strings(seed, n):
    rng = np.random.default_rng(seed)
    seps = [" ", "  ", "\t", "-", " - ", "\n", ""]
    out = ["", "   ", "Hello  World", "Foo-Bar baz", "trailing   ", "  leading", "x"]
    for toks in _documents(seed, n):
        out.append("".join(t + seps[int(rng.integers(0, len(seps)))] for t in toks))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_tokenizer(seed):
    got, want = _run(*_pair(Tokenizer().set_input_col("s").set_output_col("t")), {"s": _strings(seed, 40)})
    _same_column(got["t"], want["t"], "tokenizer")
    assert got["t"][2] == ["hello", "", "world"]


REGEX_PARAMS = [
    {},
    {"pattern": r"[\s\-]+"},
    {"pattern": r"\w+", "gaps": False},
    {"pattern": r"\s", "min_token_length": 0},
    {"min_token_length": 3},
    {"to_lowercase": False},
    {"pattern": r"[a-z]+", "gaps": False, "to_lowercase": False, "min_token_length": 2},
]


@pytest.mark.parametrize("params", REGEX_PARAMS, ids=[str(p) for p in REGEX_PARAMS])
def test_regex_tokenizer(params):
    stage, twin = _pair(RegexTokenizer().set_input_col("s").set_output_col("t"), **params)
    got, want = _run(stage, twin, {"s": _strings(7, 40)})
    _same_column(got["t"], want["t"], f"regex {params}")


SWR_PARAMS = [
    {},
    {"case_sensitive": True},
    {"locale": "tr_TR"},
    {"stop_words": ("alpha", "İstanbul", "I")},
    {"stop_words": ("alpha", "İstanbul", "I"), "locale": "az_AZ"},
    {"stop_words": ("δέλτα",), "case_sensitive": True},
]


@pytest.mark.parametrize("params", SWR_PARAMS, ids=[str(p) for p in SWR_PARAMS])
def test_stop_words_remover(params):
    stage, twin = _pair(StopWordsRemover().set_input_cols("a", "b").set_output_cols("fa", "fb"), **params)
    got, want = _run(stage, twin, {"a": _documents(3, 30), "b": _documents(4, 30)})
    for col in ("fa", "fb"):
        _same_column(got[col], want[col], f"stopwords {params} {col}")


def test_stop_word_lists_are_the_jax_packages():
    assert StopWordsRemover.get_available_locales() == JStopWordsRemover.get_available_locales()
    assert len(StopWordsRemover.get_available_locales()) == 14
    for lang in StopWordsRemover.get_available_locales():
        assert StopWordsRemover.load_default_stop_words(lang) == JStopWordsRemover.load_default_stop_words(lang)
    assert StopWordsRemover().get_stop_words() == JStopWordsRemover().get_stop_words()
    with pytest.raises(ValueError, match="supported language"):
        StopWordsRemover.load_default_stop_words("klingon")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram(n):
    docs = _documents(5, 30, max_len=6) + [["a", "b", "c", "d"], ["x"], []]
    stage, twin = _pair(NGram().set_input_col("t"), n=n)
    got, want = _run(stage, twin, {"t": docs})
    _same_column(got["output"], want["output"], f"ngram {n}")


HTF_TERMS = [None, True, False, np.bool_(True), 0, 1, -1, 2**31, 2**40, 1.0, -0.0, 0.0, 2.5,
             "a", "b", "A", "", "😀", "the"]


@pytest.mark.parametrize("num_features,binary", [(1, False), (32, False), (32, True), (64, False),
                                                 (1 << 18, False), (1 << 18, True), (1000, False)])
def test_hashing_tf(num_features, binary):
    rng = np.random.default_rng(num_features)
    docs = [[HTF_TERMS[i] for i in rng.integers(0, len(HTF_TERMS), k)] for k in rng.integers(0, 20, 40)]
    docs += [["a", "b", "a"], [], ["a"] * 30]
    stage, twin = _pair(HashingTF().set_input_col("terms"), num_features=num_features, binary=binary)
    got, want = _run(stage, twin, {"terms": docs})
    _same_column(got["output"], want["output"], f"hashingtf {num_features} {binary}")
    v = got["output"][-3]
    assert sorted(v.values.tolist()) == ([1.0, 1.0] if binary else [1.0, 2.0]) or num_features == 1


def test_hashing_tf_rejects_what_jax_rejects():
    for stage in (HashingTF().set_input_col("t"),):
        with pytest.raises(TypeError):
            stage.transform(DataFrame(["t"], None, [[[object()]]]), device="cpu")


def _hasher_columns(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "num": rng.normal(size=n),
        "ints": rng.integers(-5, 5, n),
        "cat": [str(v) for v in rng.choice(["red", "green", "blue"], n)],
        "flag": [bool(v) for v in rng.integers(0, 2, n)],
        "dcat": rng.integers(0, 4, n).astype(np.float64),
        "opt": [None if v < 0.3 else float(v) for v in rng.random(n)],
    }


HASHER_PARAMS = [
    (("num", "cat"), (), 16),
    (("num", "ints", "cat", "flag"), (), 1000),
    (("num", "dcat", "cat"), ("dcat",), 8),
    (("num", "dcat", "opt", "flag"), ("dcat", "flag"), 1 << 18),
    (("num", "ints", "dcat"), ("ints",), 1),
]


@pytest.mark.parametrize("cols,cats,num_features", HASHER_PARAMS)
def test_feature_hasher(cols, cats, num_features):
    stage, twin = _pair(FeatureHasher().set_output_col("h"), input_cols=cols, categorical_cols=cats,
                        num_features=num_features)
    got, want = _run(stage, twin, _hasher_columns(len(cols) + num_features, 50))
    _same_column(got["h"], want["h"], f"featurehasher {cols} {cats} {num_features}")


def test_feature_hasher_accumulates_in_column_order():
    # colliding numeric columns at one index: the sum runs in column order
    cols = {"a": np.float64([1e8, 1.0]), "b": np.float64([1.0, 1e8]), "c": np.float64([-1e8, -1e8])}
    stage, twin = _pair(FeatureHasher().set_output_col("h"), input_cols=("a", "b", "c"), num_features=1)
    got, want = _run(stage, twin, cols)
    _same_column(got["h"], want["h"], "featurehasher order")
    assert [v.values.tolist() for v in got["h"]] == [[0.0], [-1e8 + 1e8]]
    with pytest.raises(ValueError, match="CategoricalCols"):
        FeatureHasher().set_input_cols("a").set_categorical_cols("b").transform(
            DataFrame.from_dict(cols), device="cpu")


CV_PARAMS = [
    {},
    {"min_df": 3.0},
    {"min_df": 0.5},
    {"max_df": 10.0},
    {"max_df": 0.6},
    {"min_df": 0.1, "max_df": 0.9},
    {"vocabulary_size": 3},
    {"vocabulary_size": 5, "binary": True},
    {"min_tf": 2.0},
    {"min_tf": 0.3},
    {"min_tf": 0.15, "binary": True},
]


def _cv_documents():
    # ties in count, so vocabularySize cuts between equal counts by term
    docs = _documents(9, 60, max_len=15, words=WORDS[:9])
    return docs + [["x"] * 3 + ["y"] * 7, ["tie1", "tie2", "tie1", "tie2"], []]


@pytest.mark.parametrize("params", CV_PARAMS, ids=[str(p) for p in CV_PARAMS])
def test_count_vectorizer(params):
    docs = _cv_documents()
    est, jest = _pair(CountVectorizer(), **params)
    df, jdf = _frames({"input": docs})
    model, jmodel = est.fit(df), jest.fit(jdf)
    assert model.vocabulary == jmodel.vocabulary
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    got, want = model.transform(df, device="cpu"), jmodel.transform(jdf)
    _same_column(got["output"], want["output"], f"countvectorizer {params}")


def test_count_vectorizer_fractional_min_tf_rounds_in_float32():
    """minTF 0.3 over a 10-token document: float64 gives a bar of
    3.0000000000000004, float32 0.3 · 10 rounds to 3.0 exactly, so a term
    seen three times is kept — as in the JAX package."""
    docs = [["x"] * 3 + ["y"] * 7]
    for package in ("port", "jax"):
        est = (CountVectorizer() if package == "port" else JCountVectorizer()).set_min_tf(0.3)
        frame = DataFrame if package == "port" else JDataFrame
        model = est.fit(frame(["input"], None, [docs]))
        out = (model.transform(frame(["input"], None, [docs]), device="cpu") if package == "port"
               else model.transform(frame(["input"], None, [docs])))
        v = out["output"][0]
        assert sorted(v.values.tolist()) == [3.0, 7.0], package


def test_count_vectorizer_errors_match():
    df, jdf = _frames({"input": _cv_documents()})
    for est, frame in ((CountVectorizer(), df), (JCountVectorizer(), jdf)):
        with pytest.raises(ValueError, match="maxDF"):
            est.set_min_df(5.0).set_max_df(2.0).fit(frame)
        with pytest.raises(RuntimeError, match="vocabulary is empty"):
            est.set_min_df(1000.0).set_max_df(2000.0).fit(frame)
    with pytest.raises(RuntimeError, match="set_model_data"):
        CountVectorizerModel().sparse_kernel_spec({})


def test_count_vectorizer_model_data_round_trip():
    model = CountVectorizer().fit(DataFrame(["input"], None, [_cv_documents()]))
    (data,) = model.get_model_data()
    back = CountVectorizerModel().set_model_data(data)
    assert back.vocabulary == model.vocabulary


def _saved_stages():
    cv = CountVectorizer().set_min_df(2.0).set_min_tf(0.25).set_vocabulary_size(6)
    return [
        Tokenizer().set_input_col("s").set_output_col("t"),
        RegexTokenizer().set_pattern("x+").set_gaps(False).set_min_token_length(2),
        StopWordsRemover().set_input_cols("t").set_output_cols("u").set_locale("tr_TR"),
        NGram().set_n(4),
        HashingTF().set_num_features(64).set_binary(True),
        FeatureHasher().set_input_cols("a", "b").set_categorical_cols("b").set_num_features(100),
        cv,
        cv.fit(DataFrame(["input"], None, [_cv_documents()])),
    ]


@pytest.mark.parametrize("index", range(8))
def test_saved_directories_load_in_both_packages(tmp_path, index):
    stage = _saved_stages()[index]
    path = str(tmp_path / "port")
    stage.save(path)
    twin_cls = TWINS[type(stage)]
    assert jrw.load_metadata(path)["className"] == rw.jax_class_name(stage)
    for loaded in (twin_cls.load(path), jrw.load_stage(path)):
        assert type(loaded) is twin_cls and loaded.param_map_to_json() == stage.param_map_to_json()
        if hasattr(stage, "vocabulary"):
            assert loaded.vocabulary == stage.vocabulary
    # and the reverse: the JAX twin's directory loads in the port
    jpath = str(tmp_path / "jax")
    twin = twin_cls.load(path)
    twin.save(jpath)
    for back in (type(stage).load(jpath), rw.load_stage(jpath)):
        assert type(back) is type(stage) and back.param_map_to_json() == stage.param_map_to_json()
        if hasattr(stage, "vocabulary"):
            assert back.vocabulary == stage.vocabulary
    if not isinstance(stage, CountVectorizer):
        assert type(type(stage).load_servable(jpath)) is type(stage)


def test_entry_points_default_to_the_card():
    df = DataFrame.from_dict({"input": [["a", "b"]], "s": ["a b"], "num": np.ones(1)})
    stages = [Tokenizer().set_input_col("s"), RegexTokenizer().set_input_col("s"),
              StopWordsRemover().set_input_cols("input").set_output_cols("o"), NGram().set_input_col("input"),
              HashingTF().set_input_col("input"), FeatureHasher().set_input_cols("num"),
              CountVectorizer().fit(df)]
    for stage in stages:
        if torch.cuda.is_available():
            stage.transform(df)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                stage.transform(df)
