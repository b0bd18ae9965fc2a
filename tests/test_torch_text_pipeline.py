"""The text pipeline — Tokenizer → HashingTF → IDF → LogisticRegression — in
the port against the JAX package on the CPU, and the ``entries`` stages in
the port's planner, batch plan and serving plan.

- fit in both packages (scatter-sparse at d 128, the 'auto' gate's one-hot
  path at d 2^14): coefficients within 1e-6 (float32 SGD whose sums round
  in another order; the one-hot crossings sum split-bf16 terms in another
  order), loss histories within 1e-5 relative;
- the port's batch plan, fused against per-stage in both tiers: bit-exact
  (the chain runs the per-stage bodies; the margin's sequential fold is
  bit-invariant to the nnz cap);
- the port's transform against the JAX package's: term counts and tf-idf
  exactly, rawPrediction within 1e-6 (float32 margins summed in another
  order), predictions equal where the float64 margin is more than 1e-4
  from 0;
- served on the CPU: keys ``(bucket, nnz cap)``, 0 builds after warmup, and
  an off-ladder batch falling back per-stage under the ``off_ladder`` reason;
- every sequence of one to three of {HashingTF, CountVectorizerModel,
  FeatureHasher, IDF, LR}: both packages' ``build_segments`` form the same
  runs, and the port's ``chain_eligible`` equals JAX's on each.

The JAX side fits on a one-device mesh, so its local batch is the port's.
"""
import itertools

import numpy as np
import pytest
import torch

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import Pipeline as JPipeline
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.models.classification.logistic_regression import (
    LogisticRegression as JLogisticRegression,
    LogisticRegressionModel as JLogisticRegressionModel,
)
from flink_ml_tpu.models.feature.count_vectorizer import CountVectorizerModel as JCountVectorizerModel
from flink_ml_tpu.models.feature.feature_hasher import FeatureHasher as JFeatureHasher
from flink_ml_tpu.models.feature.hashing_tf import HashingTF as JHashingTF
from flink_ml_tpu.models.feature.idf import IDF as JIDF, IDFModel as JIDFModel
from flink_ml_tpu.models.feature.tokenizer import Tokenizer as JTokenizer
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.servable.megakernels import chain_eligible as jax_chain_eligible
from flink_ml_tpu.servable.planner import FusedSegment as JFusedSegment
from flink_ml_tpu.servable.planner import build_segments as jax_build_segments

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.builder import Pipeline, PipelineModel
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.classification.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.models.feature import (
    IDF,
    CountVectorizerModel,
    FeatureHasher,
    HashingTF,
    IDFModel,
    Tokenizer,
)
from flink_ml_tpu_torch.servable.fusion import FusionTier
from flink_ml_tpu_torch.servable.megakernels import chain_eligible
from flink_ml_tpu_torch.servable.planner import FusedSegment, build_segments
from flink_ml_tpu_torch.servable.sparse import resolve_sparse_hints
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds

torch.set_num_threads(1)

MARGIN = 1e-4
OUT_COLS = ("tokens", "tf", "tfidf", "prediction", "rawPrediction")


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets, in either package, is unset after it:
    the test workers run other files in the same process."""
    yield
    for opt in (Options.SPARSE_NNZ_CAP_MAX, Options.SPARSE_WARMUP_CAPS, Options.FUSION_MODE,
                Options.BATCH_FASTPATH, Options.BATCH_CHUNK_ROWS, Options.SPARSE_FASTPATH):
        config.unset(opt)
    for opt in (JOptions.SPARSE_NNZ_CAP_MAX, JOptions.FUSION_MODE, JOptions.BATCH_FASTPATH):
        jconfig.unset(opt)


def _words(n, seed):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return sorted({"".join(rng.choice(letters, int(k))) for k in rng.integers(2, 8, n * 2)})[:n]


def _documents(n, seed, vocab=40, max_tokens=12):
    """Seeded documents over a vocabulary, some with doubled spaces (empty
    tokens); the label is a rule over the tokens, so the fit has signal."""
    rng = np.random.default_rng(seed)
    words = _words(vocab, seed + 1)
    positive = set(words[::3])
    docs, labels = [], []
    for k in rng.integers(0, max_tokens + 1, n):
        toks = [words[i] for i in rng.integers(0, len(words), k)]
        docs.append(("  " if rng.random() < 0.1 else " ").join(t.upper() if rng.random() < 0.1 else t
                                                                 for t in toks))
        labels.append(float(sum(t.lower() in positive for t in toks) * 2 > len(toks)))
    return {"text": docs, "label": np.asarray(labels)}


def _stages(jax, dim, iters=6, batch=64, lr=0.5):
    tok, htf, idf, lreg = ((JTokenizer, JHashingTF, JIDF, JLogisticRegression) if jax
                           else (Tokenizer, HashingTF, IDF, LogisticRegression))
    return [
        tok().set_input_col("text").set_output_col("tokens"),
        htf().set_input_col("tokens").set_output_col("tf").set_num_features(dim),
        idf().set_input_col("tf").set_output_col("tfidf"),
        lreg().set_features_col("tfidf").set_max_iter(iters).set_global_batch_size(batch)
        .set_learning_rate(lr).set_tol(0.0),
    ]


def _fit_both(columns, dim, **kw):
    stages, jstages = _stages(False, dim, **kw), _stages(True, dim, **kw)
    model = Pipeline(stages).fit(DataFrame.from_dict(columns), device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jmodel = JPipeline(jstages).fit(JDataFrame.from_dict(columns))
    return stages[-1], model, jstages[-1], jmodel


def _same_sparse(got, want, where):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.size() == w.size(), (where, i)
        np.testing.assert_array_equal(g.indices, w.indices, err_msg=f"{where} row {i}")
        np.testing.assert_array_equal(np.asarray(g.values).view(np.int64), np.asarray(w.values).view(np.int64),
                                      err_msg=f"{where} row {i}")


def _bitexact(a, b):
    assert a.get_column_names() == b.get_column_names()
    for name in a.get_column_names():
        ca, cb = a.column(name), b.column(name)
        if isinstance(ca, np.ndarray):
            assert ca.dtype == np.asarray(cb).dtype, name
            np.testing.assert_array_equal(ca.view(np.int64) if ca.dtype == np.float64 else ca,
                                          np.asarray(cb).view(np.int64) if ca.dtype == np.float64 else cb,
                                          err_msg=name)
        elif ca and hasattr(ca[0], "indices"):
            _same_sparse(ca, cb, name)
        else:
            assert list(ca) == list(cb), name


def _hold_against_jax(out, jout, coef):
    assert out.column("tokens") == jout.column("tokens")
    _same_sparse(out.column("tf"), jout.column("tf"), "tf")
    _same_sparse(out.column("tfidf"), jout.column("tfidf"), "tfidf")
    np.testing.assert_allclose(out.column("rawPrediction"), np.asarray(jout.column("rawPrediction")),
                               rtol=0, atol=1e-6)
    margin = np.array([v.values @ coef[v.indices] for v in out.column("tfidf")])
    decided = np.abs(margin) > MARGIN
    np.testing.assert_array_equal(np.asarray(out.column("prediction"))[decided],
                                  np.asarray(jout.column("prediction"))[decided])


_FITS = {}


def _fitted(path):
    """The pipeline fitted in both packages, once a module: d 128 on 300
    documents (the scatter path), and d 2^14 on 8192 documents of up to 14
    tokens over a 2000-word vocabulary (2^17 index slots, 8 windows: the
    one-hot path)."""
    if path not in _FITS:
        if path == "scatter":
            columns, dim, kw = _documents(300, 3), 128, {}
        else:
            columns, dim, kw = _documents(8192, 4, vocab=2000, max_tokens=14), 1 << 14, {"batch": 1024}
        _FITS[path] = (path, columns, dim, _fit_both(columns, dim, **kw))
    return _FITS[path]


@pytest.fixture(params=["scatter", "onehot"])
def fitted(request):
    return _fitted(request.param)


def test_text_pipeline_fit_matches_the_jax_package(fitted):
    path, columns, dim, (est, model, jest, jmodel) = fitted
    assert est.onehot_premat_active == (path == "onehot")
    coef = np.asarray(model.stages[-1].coefficient)
    np.testing.assert_allclose(coef, np.asarray(jmodel.stages[-1].coefficient), rtol=0, atol=1e-6)
    np.testing.assert_allclose(est.loss_history, jest.loss_history, rtol=1e-5)
    np.testing.assert_array_equal(model.stages[2].idf, jmodel.stages[2].idf)
    assert np.abs(coef).max() > 1e-3  # the fit moved


def test_batch_transform_fused_equals_per_stage_and_jax(fitted):
    path, columns, dim, (_est, model, _jest, jmodel) = fitted
    rows = np.arange(min(700, len(columns["label"])))
    df = DataFrame.from_dict(columns).take(rows)
    config.set(Options.BATCH_FASTPATH, False)
    slow = model.transform(df, device="cpu")
    config.set(Options.BATCH_FASTPATH, True)
    config.set(Options.BATCH_CHUNK_ROWS, 256)  # two full chunks and a tail
    for mode in ("exact", "fast"):
        config.set(Options.FUSION_MODE, mode)
        fused_rows = metrics.get("ml.batch[plan]", MLMetrics.BATCH_FUSED_ROWS, 0)
        fast = model.transform(df, device="cpu")
        assert metrics.get("ml.batch[plan]", MLMetrics.BATCH_FUSED_ROWS, 0) == fused_rows + len(rows)
        _bitexact(slow, fast)
        plan = model._plan_cache[1]
        (seg,) = [s for s in plan.segments if isinstance(s, FusedSegment)]
        assert seg.has_sparse_inputs and seg.external_inputs == ("tokens",)
        elementwise = [[s.elementwise for s in p.specs] for p in seg.programs]
        # exact: combine (a reduction) | idf (elementwise) | the head; fast: one merged program
        assert elementwise == ([[False], [True], [False]] if mode == "exact" else [[False, True, False]])
        assert all(p.kind != "megakernel" for p in seg.programs)
    jout = jmodel.transform(JDataFrame.from_dict(columns).take(rows))
    _hold_against_jax(slow, jout, np.asarray(model.stages[-1].coefficient, np.float32).astype(np.float64))


def test_saved_pipeline_loads_across_packages_and_transforms_alike(fitted, tmp_path):
    _path, columns, _dim, (_est, model, _jest, jmodel) = fitted
    model.save(str(tmp_path / "port"))
    from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel

    back = JPipelineModel.load(str(tmp_path / "port"))
    rows = np.arange(200)
    jout = back.transform(JDataFrame.from_dict(columns).take(rows))
    out = PipelineModel.load(str(tmp_path / "port")).transform(DataFrame.from_dict(columns).take(rows),
                                                                device="cpu")
    _hold_against_jax(out, jout, np.asarray(model.stages[-1].coefficient, np.float32).astype(np.float64))


def test_empty_documents_ride_the_chain(fitted):
    _path, _columns, _dim, (_est, model, _jest, _jmodel) = fitted
    for docs in (["", "alpha beta", ""], ["", "", "", ""]):
        df = DataFrame.from_dict({"text": docs})
        config.set(Options.BATCH_FASTPATH, False)
        slow = model.transform(df, device="cpu")
        config.set(Options.BATCH_FASTPATH, True)
        _bitexact(slow, model.transform(df, device="cpu"))


def test_served_on_the_cpu_by_bucket_and_cap(tmp_path):
    _path, columns, _dim, (_est, model, _jest, jmodel) = _fitted("scatter")
    model.save(str(tmp_path / "m"))
    servable = PipelineModel.load_servable(str(tmp_path / "m"))
    config.set(Options.SPARSE_NNZ_CAP_MAX, 16)  # warmup covers the ladder 1 … 16
    df = DataFrame.from_dict(columns)
    jdf = JDataFrame.from_dict(columns)
    expected = jmodel.transform(jdf)
    coef = np.asarray(model.stages[-1].coefficient, np.float32).astype(np.float64)
    cfg = ServingConfig(max_batch_size=8, max_delay_ms=0.0, fusion_mode="fast")
    template = df.take([1])
    with InferenceServer(servable, name="ttp-serve", serving_config=cfg, device="cpu",
                         warmup_template=template) as srv:
        keys = set(chain_kinds(servable._fastpath_plan))
        assert keys == {(b, c) for b in (1, 2, 4, 8) for c in (1, 2, 4, 8, 16)}
        for start, n in zip(range(0, 60, 7), (1, 5, 8, 3, 7, 2, 8, 6, 4)):
            take = np.arange(start, start + n)
            resp = srv.predict(df.take(take))
            assert resp.dataframe.get_column_names() == ["text", "label", *OUT_COLS]
            _hold_against_jax(resp.dataframe, expected.take(take), coef)
        assert metrics.get(srv.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0
        assert metrics.get(srv.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 0
        # a document of 20 distinct tokens is off the ladder (cap max 16)
        long_doc = {"text": [" ".join(_words(20, 9)), columns["text"][0]], "label": np.zeros(2)}
        resp = srv.predict(DataFrame.from_dict(long_doc))
        assert metrics.get(srv.scope, MLMetrics.fallback_reason("serving", "off_ladder"), 0) == 1
        assert metrics.get(srv.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 1
        _hold_against_jax(resp.dataframe, jmodel.transform(JDataFrame.from_dict(long_doc)), coef)
        assert resp.dataframe.column("tf")[0].values.sum() == 20.0


def test_off_ladder_batch_transform_falls_back_reason_labelled(fitted):
    _path, columns, _dim, (_est, model, _jest, _jmodel) = fitted
    config.set(Options.SPARSE_NNZ_CAP_MAX, 4)
    df = DataFrame.from_dict(columns).take(np.arange(64))
    reason = MLMetrics.fallback_reason("batch", "off_ladder")
    before = metrics.get("ml.batch[plan]", reason, 0)
    config.set(Options.BATCH_FASTPATH, False)
    slow = model.transform(df, device="cpu")
    config.set(Options.BATCH_FASTPATH, True)
    _bitexact(slow, model.transform(df, device="cpu"))
    assert metrics.get("ml.batch[plan]", reason, 0) == before + 1


def test_serving_plan_warms_entries_shape_only():
    """Warmup packs the template at every cap of the ladder, clipping rows
    longer than a rung (``truncate``): a 12-token template warms cap 1."""
    hashing = HashingTF().set_input_col("tokens").set_output_col("tf").set_num_features(64)
    config.set(Options.SPARSE_NNZ_CAP_MAX, 16)
    plan = CompiledServingPlan.build(hashing, scope="ttp-warm", device="cpu", sparse={})
    template = DataFrame.from_dict({"tokens": [[f"t{i}" for i in range(12)]]})
    plan.warmup(template, (1, 4))
    (seg,) = plan.segments
    assert set(seg.compiled) == {(b, c) for b in (1, 4) for c in (1, 2, 4, 8, 16)}
    assert resolve_sparse_hints(template) == {}


_D = 16


def _pool(jax):
    """One stage of each sparse-convention form, in either package, all
    writing (and IDF and LR reading) the column ``f`` of width 16."""
    rng = np.random.default_rng(3)
    htf = (JHashingTF if jax else HashingTF)().set_input_col("tok").set_output_col("f").set_num_features(_D)
    cv = (JCountVectorizerModel if jax else CountVectorizerModel)().set_input_col("tok").set_output_col("f")
    cv.vocabulary = [f"w{i}" for i in range(_D)]
    fh = (JFeatureHasher if jax else FeatureHasher)().set_input_cols("a", "b").set_output_col("f")
    fh.set_num_features(_D)
    idf = (JIDFModel if jax else IDFModel)().set_input_col("f").set_output_col("f")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=_D)), np.ones(_D), np.asarray(5.0)
    lr = (JLogisticRegressionModel if jax else LogisticRegressionModel)().set_features_col("f")
    lr.coefficient = rng.normal(size=_D)
    return {"hashingtf": htf, "countvectorizer": cv, "featurehasher": fh, "idf": idf, "lr": lr}


def test_every_chain_of_entries_stages_plans_as_in_jax():
    """Every sequence of one to three of the five, planned in both tiers by
    both packages with nothing known sparse up front: the same segments and
    runs, and ``chain_eligible`` equal on each run (the featurizers carry no
    ``fusion_op``, so a run holding one is refused in both)."""
    port, jax = _pool(False), _pool(True)
    runs_seen = refused = 0
    for tier in ("exact", "fast"):
        fusion, jfusion = FusionTier(tier), JFusionTier(tier)
        for n in (1, 2, 3):
            for names in itertools.product(sorted(port), repeat=n):
                segs = build_segments([port[k] for k in names], torch.device("cpu"), fusion, {})
                jsegs = jax_build_segments([jax[k] for k in names], None, jfusion, {})
                assert [type(s).__name__ for s in segs] == [type(s).__name__ for s in jsegs], names
                runs = [[sp.input_kinds for sp in p.specs] for s in segs if isinstance(s, FusedSegment)
                        for p in s.programs]
                jruns = [[sp.input_kinds for sp in p.specs] for s in jsegs if isinstance(s, JFusedSegment)
                         for p in s.programs]
                assert runs == jruns, names
                for seg, jseg in zip(segs, jsegs):
                    if isinstance(seg, FusedSegment):
                        assert seg.external_inputs == jseg.external_inputs, names
                        assert seg.has_sparse_inputs == jseg.has_sparse_inputs, names
                        for prog, jprog in zip(seg.programs, jseg.programs):
                            runs_seen += 1
                            ok = chain_eligible(prog.specs)
                            assert ok == jax_chain_eligible(jprog.specs), names
                            refused += not ok
    assert runs_seen > 300 and refused > 100, (runs_seen, refused)
