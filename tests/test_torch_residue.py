"""The table kernels' last four classes of chains against the JAX package on
the CPU, and saved models across the two packages.

The classes are the chains the JAX package lowers as one Pallas megakernel
that need the table's sparse ops, typed slots or MLP phases
(``flink_ml_tpu_torch/servable/megakernels.py``):

- ``sparse_with_dense`` — sparse and dense ops in one run;
- ``other_sparse_run`` — sparse runs other than IDF alone, the sparse head
  alone and IDF → LR;
- ``mlp_not_last`` — ops after an MLP head;
- ``reads_kmeans_index`` — an op reading a kmeans index column.

For each, the port's ``build_megakernel_fn`` on CPU tensors (the plain
table, ``rowlocal_chain_plain``) is held against the JAX
``build_megakernel_fn(..., interpret=True)`` on the same specs, and the
chain's ``PipelineModel`` against the JAX ``PipelineModel.transform`` in both
plan tiers, the serving plan per bucket and the batch plan at a 65,536-row
chunk, with the cost model's choice per bucket equal to JAX's. Tests of the
CUDA kernels themselves are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- float outputs within 1024 f32 ulps (``ULP_ENVELOPE['feature6']``, the
  chain tests' bound: XLA and PyTorch sum a normalize's row, a dot or a
  layer in other orders);
- binarize outputs equal wherever the input lies more than 1e-5 from the
  threshold (the input itself is held to the envelope above);
- ids, nnz, kmeans indices and MLP predictions exactly equal (the data keep
  every top-two gap wide);
- every output's dtype equal to JAX's.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.logistic_regression import (
    LogisticRegressionModel as JLogisticRegressionModel,
)
from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifierModel as JMLPClassifierModel
from flink_ml_tpu.models.clustering.kmeans import KMeansModel as JKMeansModel
from flink_ml_tpu.models.feature.binarizer import Binarizer as JBinarizer
from flink_ml_tpu.models.feature.idf import IDFModel as JIDFModel
from flink_ml_tpu.models.feature.imputer import ImputerModel as JImputerModel
from flink_ml_tpu.models.feature.normalizer import Normalizer as JNormalizer
from flink_ml_tpu.models.feature.standard_scaler import StandardScalerModel as JStandardScalerModel
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier, ulp_diff
from flink_ml_tpu.servable.megakernels import build_megakernel_fn as jax_build_megakernel_fn
from flink_ml_tpu.servable.megakernels import chain_eligible as jax_chain_eligible
from flink_ml_tpu.servable.planner import FusedSegment as JFusedSegment
from flink_ml_tpu.servable.planner import build_segments as jax_build_segments
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan
from flink_ml_tpu.utils import read_write as jrw

import flink_ml_tpu_torch.servable as torch_lib
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.builder import PipelineModel
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.vectors import SparseVector
from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifierModel
from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel
from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
from flink_ml_tpu_torch.models.feature.idf import IDFModel
from flink_ml_tpu_torch.models.feature.imputer import ImputerModel
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScalerModel
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier
from flink_ml_tpu_torch.servable.megakernels import (
    ROWLOCAL_MAX_DIM,
    build_megakernel_fn,
    chain_eligible,
    inputs_fit,
)
from flink_ml_tpu_torch.servable.planner import FusedSegment, build_segments
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

ENVELOPE = ULP_ENVELOPE["feature6"]
BIN_MARGIN = 1e-5
D_SPARSE = 16  # the sparse columns' dimension
ROWS = (1, 33, 300)

#: class -> chain -> the fusion ops the planner must form, one run.
CHAINS = {
    "sparse_with_dense": {
        "idf_lr_scale": ("sparse_idf", "sparse_logistic", "scale"),
        "scale_idf_lr": ("scale", "sparse_idf", "sparse_logistic"),
        "idf_normalize": ("sparse_idf", "normalize"),
    },
    "other_sparse_run": {
        "idf_idf": ("sparse_idf", "sparse_idf"),
        "idf_idf_lr": ("sparse_idf", "sparse_idf", "sparse_logistic"),
    },
    "mlp_not_last": {
        "mlp_scale": ("mlp", "scale"),
        "normalize_mlp_binarize": ("normalize", "mlp", "binarize"),
        "mlp_kmeans": ("mlp", "kmeans"),
    },
    "reads_kmeans_index": {
        "kmeans_binarize": ("kmeans", "binarize"),
        "kmeans_impute": ("kmeans", "impute"),
    },
}
CASES = [(cls, name) for cls, chains in CHAINS.items() for name in chains]
#: outputs compared by the binarize rule: output -> (its input, threshold)
BINARIZED = {"rb": ("rawPrediction", 0.3), "pb": ("prediction", 0.5)}


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets is unset after it, in both packages:
    the test workers run other files in the same process."""
    yield
    for option in (Options.BATCH_CHUNK_ROWS, Options.FUSION_MODE, Options.FUSION_MEGAKERNEL_MIN_SCORE,
                   Options.SPARSE_FASTPATH):
        config.unset(option)
    for option in (JOptions.BATCH_CHUNK_ROWS, JOptions.FUSION_MODE, JOptions.FUSION_MEGAKERNEL_MIN_SCORE,
                   JOptions.SPARSE_FASTPATH):
        jconfig.unset(option)


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


# ---------------------------------------------------------------------------
# the chains' stages, in either package, from seeded numpy model data
# ---------------------------------------------------------------------------


def _stages(name, d, jax, seed=0):
    """The stages of chain ``name`` at dense width ``d``, each one that
    exposes a kernel spec (a servable, or a stage that is its own), with the
    same numpy weights in both packages."""
    rng = np.random.default_rng(seed)
    lib = jlib if jax else torch_lib
    pick = (lambda port, j: j) if jax else (lambda port, j: port)

    def scaler(inp, out):
        s = lib.StandardScalerModelServable().set_input_col(inp).set_output_col(out).set_with_mean(True)
        s.mean, s.std = rng.normal(size=d), np.abs(rng.normal(size=d)) + 0.5
        return s

    def idf(inp, out):
        s = pick(IDFModel, JIDFModel)().set_input_col(inp).set_output_col(out)
        s.idf, s.doc_freq, s.num_docs = np.abs(rng.normal(size=D_SPARSE)) + 0.1, np.ones(D_SPARSE), np.asarray(9.0)
        return s

    def lr(inp):
        s = lib.LogisticRegressionModelServable().set_features_col(inp)
        s.coefficient = rng.normal(size=D_SPARSE)
        return s

    def normalizer(inp, out):
        return pick(Normalizer, JNormalizer)().set_input_col(inp).set_output_col(out).set_p(2.0)

    def mlp(inp):
        widths = (d, 12, 4)
        s = lib.MLPClassifierModelServable().set_features_col(inp)
        arrays = {"labels": np.arange(widths[-1], dtype=np.float64) * 2.0 + 1.0}
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            arrays[f"W{i}"] = (rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
            arrays[f"b{i}"] = (rng.normal(size=b) * 0.1).astype(np.float32)
        return s._apply_model_arrays(arrays)

    def kmeans(inp, out, k=3):
        s = lib.KMeansModelServable().set_features_col(inp).set_prediction_col(out).set_k(k)
        s.centroids, s.weights = (rng.normal(size=(k, d)) * 2.0).astype(np.float32), np.ones(k)
        return s

    def binarizer(inp, out, threshold):
        return pick(Binarizer, JBinarizer)().set_input_cols(inp).set_output_cols(out).set_thresholds(threshold)

    def imputer(inp, out):
        s = pick(ImputerModel, JImputerModel)().set_input_cols(inp).set_output_cols(out).set_missing_value(1.0)
        s.surrogates = np.asarray([7.5])
        return s

    return {
        "idf_lr_scale": lambda: [idf("f", "t"), lr("t"), scaler("x", "xs")],
        "scale_idf_lr": lambda: [scaler("x", "xs"), idf("f", "t"), lr("t")],
        "idf_normalize": lambda: [idf("f", "t"), normalizer("x", "xn")],
        "idf_idf": lambda: [idf("f", "t"), idf("t", "u")],
        "idf_idf_lr": lambda: [idf("f", "t"), idf("t", "u"), lr("u")],
        "mlp_scale": lambda: [mlp("x"), scaler("x", "xs")],
        "normalize_mlp_binarize": lambda: [normalizer("x", "xn"), mlp("xn"), binarizer("rawPrediction", "rb", 0.3)],
        "mlp_kmeans": lambda: [mlp("x"), kmeans("x", "cluster")],
        "kmeans_binarize": lambda: [kmeans("x", "prediction"), binarizer("prediction", "pb", 0.5)],
        "kmeans_impute": lambda: [kmeans("x", "prediction"), imputer("prediction", "pi")],
    }[name]()


def _columns(name, rows, d, cap, seed):
    """``(dense x [rows, d], sparse rows of 0–cap entries or None)``: a row
    of zeros, short rows and empty ones among them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, d)) * 1.5
    if rows > 3:
        x[2] = 0.0
    sparse = None
    if "idf" in name:
        sparse = []
        for r in range(rows):
            k = int(rng.integers(0, cap + 1)) if r else cap
            ids = np.sort(rng.choice(D_SPARSE, size=k, replace=False))
            sparse.append((ids, rng.random(k) + 0.5))
    return x, sparse


def _frame(x, sparse, jax):
    cols = {"x": x}
    if sparse is not None:
        cls = JSparseVector if jax else SparseVector
        cols["f"] = [cls(D_SPARSE, ids, vals) for ids, vals in sparse]
    return (JDataFrame if jax else DataFrame).from_dict(cols)


def _hints(sparse):
    return {"f": D_SPARSE} if sparse is not None else {}


def _one_run(name, d, sparse):
    """The chain's one fast-tier run in both packages: ``(port specs and
    models, JAX specs and models and inputs)``."""
    hints = _hints(sparse)
    segs = [s for s in build_segments(_stages(name, d, jax=False), torch.device("cpu"),
                                      FusionTier("fast"), hints) if isinstance(s, FusedSegment)]
    jsegs = [s for s in jax_build_segments(_stages(name, d, jax=True), None, JFusionTier("fast"),
                                           hints) if isinstance(s, JFusedSegment)]
    ((prog,),), ((jprog,),) = [s.programs for s in segs], [s.programs for s in jsegs]
    assert [s.fusion_op for s in prog.specs] == [s.fusion_op for s in jprog.specs]
    return prog, jprog


def _program_inputs(names, x, sparse, cap):
    """The program inputs by name as numpy: ``x`` and the sparse triple of
    ``f`` packed at ``cap`` (padding id 0 / value 0)."""
    out = {"x": np.asarray(x, np.float32)}
    if sparse is not None:
        rows = len(sparse)
        ids = np.zeros((rows, cap), np.int32)
        vals = np.zeros((rows, cap), np.float32)
        nnz = np.zeros(rows, np.int32)
        for r, (i, v) in enumerate(sparse):
            ids[r, :len(i)], vals[r, :len(i)], nnz[r] = i, v, len(i)
        out.update({"f!values": vals, "f!ids": ids, "f!nnz": nnz})
    return {n: out[n] for n in names}


def _assert_outputs(got, want, where):
    """Every output the JAX kernel writes, by this file's tolerances."""
    assert set(got) == set(want), where
    for name, w in want.items():
        g = got[name].numpy()
        w = np.asarray(w)
        assert str(g.dtype) == str(w.dtype), (where, name, g.dtype, w.dtype)
        assert g.shape == w.shape, (where, name, g.shape, w.shape)
        if name in BINARIZED:
            src, threshold = BINARIZED[name]
            far = np.abs(np.asarray(want[src], np.float64) - threshold) > BIN_MARGIN
            np.testing.assert_array_equal(g[far], w[far], err_msg=f"{where} {name}")
        elif w.dtype == np.int32 or name in ("prediction", "cluster"):
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")
        else:
            assert ulp_diff(g, w) <= ENVELOPE, (where, name, ulp_diff(g, w))


# ---------------------------------------------------------------------------
# each class against the JAX megakernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls,name", CASES)
@pytest.mark.parametrize("rows", ROWS)
def test_each_class_matches_the_jax_megakernel(cls, name, rows):
    for d, cap in ((4, 1), (16, 8)):
        x, sparse = _columns(name, rows, d, cap, seed=rows + d)
        prog, jprog = _one_run(name, d, sparse)
        assert chain_eligible(prog.specs) and jax_chain_eligible(jprog.specs)
        inputs = _program_inputs(prog.inputs, x, sparse, cap)
        tensors = {n: torch.from_numpy(a) for n, a in inputs.items()}
        assert inputs_fit(prog.specs, tensors)
        got = build_megakernel_fn(prog.specs)(prog.models, tensors)
        jmega = jax_build_megakernel_fn(jprog.specs, jprog.models, jprog.inputs, interpret=True)
        want = jmega(jprog.models, {n: jnp.asarray(a) for n, a in inputs.items()})
        _assert_outputs(got, want, f"{cls} {name} rows={rows} d={d} cap={cap}")


def test_the_classes_dtypes_follow_the_jax_kernel_fns():
    """binarize on the int32 kmeans index is int32, impute on it float32;
    the MLP's prediction is labels[argmax] as float32; a sparse IDF's ids
    and nnz pass through as int32, the input tensors themselves."""
    x, sparse = _columns("kmeans_binarize", 33, 8, 4, seed=1)
    dtypes = {}
    for name in ("kmeans_binarize", "kmeans_impute", "mlp_scale", "idf_idf"):
        x, sparse = _columns(name, 33, 8, 4, seed=1)
        prog, _ = _one_run(name, 8, sparse)
        tensors = {n: torch.from_numpy(a) for n, a in _program_inputs(prog.inputs, x, sparse, 4).items()}
        out = build_megakernel_fn(prog.specs)(prog.models, tensors)
        dtypes.update({k: v.dtype for k, v in out.items()})
        if name == "idf_idf":
            assert out["u!ids"] is tensors["f!ids"] and out["u!nnz"] is tensors["f!nnz"]
    assert dtypes["pb"] == torch.int32 and dtypes["pi"] == torch.float32
    assert dtypes["prediction"] == torch.float32 and dtypes["rawPrediction"] == torch.float32
    assert dtypes["u!values"] == torch.float32 and dtypes["u!ids"] == torch.int32


def test_a_sparse_cap_past_the_table_stays_on_the_merged_program():
    """A sparse column's nnz cap is a slot width: past ROWLOCAL_MAX_DIM the
    batch does not fit the table kernel (the merged program runs it)."""
    prog, _ = _one_run("idf_lr_scale", 4, [])
    fits = {n: torch.zeros((2, 4)) for n in ("x",)}
    for cap, ok in ((ROWLOCAL_MAX_DIM, True), (ROWLOCAL_MAX_DIM + 1, False)):
        fits.update({"f!values": torch.zeros((2, cap)), "f!ids": torch.zeros((2, cap), dtype=torch.int32),
                     "f!nnz": torch.zeros(2, dtype=torch.int32)})
        assert inputs_fit(prog.specs, fits) == ok, cap


# ---------------------------------------------------------------------------
# through the pipeline in both plan tiers
# ---------------------------------------------------------------------------


def _plans(name, d, sparse, min_score):
    """Serving plans of the chain's servables in both tiers and packages."""
    out = []
    for mode in ("exact", "fast"):
        out.append((
            CompiledServingPlan.build(_pipeline_servable(name, d, jax=False), scope=f"res-{name}-{mode}",
                                      device="cpu", sparse=_hints(sparse) or None,
                                      fusion=FusionTier(mode, min_score=min_score)),
            JPlan.build(_pipeline_servable(name, d, jax=True), scope=f"resj-{name}-{mode}",
                        sparse=_hints(sparse) or None, fusion=JFusionTier(mode, min_score=min_score)),
        ))
    return out


def _pipeline_servable(name, d, jax):
    from flink_ml_tpu.servable.builder import PipelineModelServable as JPipelineServable

    from flink_ml_tpu_torch.servable import PipelineModelServable

    return (JPipelineServable if jax else PipelineModelServable)(_stages(name, d, jax))


def _assert_frames(out, ref, where):
    """A transformed frame against the JAX one: every JAX column, by this
    file's tolerances (sparse columns by their ids and values)."""
    for col in ref.get_column_names():
        if col in ("x", "f"):
            continue
        r = ref.column(col)
        g = out.column(col)
        if not isinstance(r, np.ndarray) and len(r) and hasattr(r[0], "indices"):
            def flat(vectors, part):
                return np.concatenate([np.asarray(getattr(v, part)) for v in vectors] + [np.zeros(0)])

            assert [len(v.indices) for v in g] == [len(v.indices) for v in r], (where, col)
            np.testing.assert_array_equal(flat(g, "indices"), flat(r, "indices"), err_msg=f"{where} {col}")
            assert ulp_diff(flat(g, "values").astype(np.float32), flat(r, "values").astype(np.float32)) <= ENVELOPE
            continue
        g, r = np.asarray(g, np.float64), np.asarray(r, np.float64)
        if col in BINARIZED:
            src, threshold = BINARIZED[col]
            far = np.abs(np.asarray(ref.column(src), np.float64) - threshold) > BIN_MARGIN
            np.testing.assert_array_equal(g[far], r[far], err_msg=f"{where} {col}")
        elif col in ("prediction", "cluster"):
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {col}")
        else:
            assert ulp_diff(g.astype(np.float32), r.astype(np.float32)) <= ENVELOPE, (where, col)


@pytest.mark.parametrize("cls,name", CASES)
def test_each_class_in_both_serving_tiers_per_bucket_matches_jax(one_device_mesh, cls, name):
    d, cap, rows = 8, 4, 300
    x, sparse = _columns(name, rows, d, cap, seed=3)
    df, jdf = _frame(x, sparse, jax=False), _frame(x, sparse, jax=True)
    ref = JPipelineModel(_stages(name, d, jax=True)).transform(jdf)
    for (plan, jplan), tier in zip(_plans(name, d, sparse, min_score=1.0), ("exact", "fast")):
        for bucket in (1, 32, rows):  # the serving buckets the frame's requests pad into
            part = df.take(list(range(bucket))) if bucket < rows else df
            jpart = jdf.take(list(range(bucket))) if bucket < rows else jdf
            jref = ref.take(list(range(bucket))) if bucket < rows else ref
            out, jout = plan.execute(part), jplan.execute(jpart)
            _assert_frames(out, jref, f"{name} {tier} bucket={bucket}")
            _assert_frames(out, jout, f"{name} {tier} bucket={bucket} vs the JAX plan")
        kinds = set(chain_kinds(plan).values())
        jkinds = {tuple(k) for s in jplan.segments if hasattr(s, "plan_kinds") for k in s.plan_kinds.values()}
        assert kinds == jkinds, (name, tier, kinds, jkinds)
        assert kinds == ({("megakernel",)} if tier == "fast" else kinds)


@pytest.mark.parametrize("cls,name", CASES)
def test_each_class_cost_model_choice_per_bucket_equals_jax(cls, name):
    """At the default bar, over the serving buckets and the batch tier's
    65,536-row chunk: the same hot/cold choice as JAX's."""
    d = 8
    x, sparse = _columns(name, 4, d, 4, seed=4)
    prog, jprog = _one_run(name, d, sparse)
    tier, jtier = FusionTier("fast"), JFusionTier("fast")
    for rows in [1 << i for i in range(13)] + [65_536]:
        for cap in ((1, 8, 64) if sparse is not None else (0,)):
            assert tier.megakernel_hot(prog.specs, rows, d, cap) == \
                jtier.megakernel_hot(jprog.specs, rows, d, cap), (name, rows, cap)


@pytest.mark.parametrize("cls,name", CASES)
def test_each_class_in_the_batch_plan_at_a_65536_row_chunk_matches_jax(one_device_mesh, cls, name):
    """``PipelineModel.transform`` in both tiers through the batch plan,
    65,536 rows in one chunk (batch.chunk.rows' default) and a ragged tail,
    against the JAX ``PipelineModel.transform``: the fast tier runs the
    chain as the megakernel on every chunk."""
    d, cap, rows = 4, 4, 65_536 + 37
    x, sparse = _columns(name, rows, d, cap, seed=5)
    df, jdf = _frame(x, sparse, jax=False), _frame(x, sparse, jax=True)
    if sparse is not None:
        config.set(Options.SPARSE_FASTPATH, True)
        jconfig.set(JOptions.SPARSE_FASTPATH, True)
    jref = JPipelineModel(_stages(name, d, jax=True)).transform(jdf)
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    for mode in ("exact", "fast"):
        config.set(Options.FUSION_MODE, mode)
        model = PipelineModel(_stages(name, d, jax=False))
        out = model.transform(df, device="cpu")
        plan = model._plan_cache[1]
        (segment,) = [s for s in plan.segments if isinstance(s, FusedSegment)]
        kinds = set(segment.plan_kinds.values())
        assert kinds == ({("megakernel",)} if mode == "fast" else kinds), (name, mode, kinds)
        assert len(segment.plan_kinds) == 2  # the full chunk and the ragged tail
        _assert_frames(out, jref, f"{name} batch {mode}")


# ---------------------------------------------------------------------------
# saved models across the two packages
# ---------------------------------------------------------------------------


def _every_port_stage():
    """One instance of every port stage that saves, with model data, and the
    JAX class its saved directory must load as."""
    from flink_ml_tpu.builder.pipeline import Pipeline as JPipeline
    from flink_ml_tpu.models.classification.attention_classifier import (
        SelfAttentionClassifier as JAttn,
        SelfAttentionClassifierModel as JAttnModel,
    )
    from flink_ml_tpu.models.classification.logistic_regression import LogisticRegression as JLR
    from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifier as JMLP
    from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
    from flink_ml_tpu.models.feature.elementwise_product import ElementwiseProduct as JProduct
    from flink_ml_tpu.models.feature.idf import IDF as JIDF
    from flink_ml_tpu.models.feature.imputer import Imputer as JImputer
    from flink_ml_tpu.models.feature.standard_scaler import StandardScaler as JStandardScaler
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
    from flink_ml_tpu.models.classification.online_logistic_regression import (
        OnlineLogisticRegression as JOnlineLR,
        OnlineLogisticRegressionModel as JOnlineLRModel,
    )
    from flink_ml_tpu.models.clustering.online_kmeans import (
        OnlineKMeans as JOnlineKMeans,
        OnlineKMeansModel as JOnlineKMeansModel,
    )
    from flink_ml_tpu.models.feature.standard_scaler import (
        OnlineStandardScaler as JOnlineScaler,
        OnlineStandardScalerModel as JOnlineScalerModel,
    )

    from flink_ml_tpu_torch.builder import Pipeline
    from flink_ml_tpu_torch.linalg.vectors import DenseVector
    from flink_ml_tpu_torch.models.classification.attention_classifier import (
        SelfAttentionClassifier,
        SelfAttentionClassifierModel,
    )
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
    from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct
    from flink_ml_tpu_torch.models.feature.idf import IDF
    from flink_ml_tpu_torch.models.feature.imputer import Imputer
    from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
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
    from flink_ml_tpu_torch.models.classification.online_logistic_regression import (
        OnlineLogisticRegression,
        OnlineLogisticRegressionModel,
    )
    from flink_ml_tpu_torch.models.clustering.online_kmeans import OnlineKMeans, OnlineKMeansModel
    from flink_ml_tpu_torch.models.feature.standard_scaler import (
        TIMESTAMP_COL,
        OnlineStandardScaler,
        OnlineStandardScalerModel,
    )
    from flink_ml_tpu_torch.ops.windows import EventTimeTumblingWindows

    rng = np.random.default_rng(6)
    scaler = StandardScalerModel().set_input_col("x").set_output_col("xs")
    scaler.mean, scaler.std = rng.normal(size=4), np.abs(rng.normal(size=4)) + 0.5
    lr = LogisticRegressionModel().set_features_col("xs")
    lr.coefficient = rng.normal(size=4)
    mlp = MLPClassifierModel().set_features_col("x")
    mlp.params = [(rng.normal(size=(4, 3)).astype(np.float32), np.zeros(3, np.float32))]
    mlp.labels = np.arange(3.0)
    km = KMeansModel().set_features_col("x").set_k(2)
    km.centroids, km.weights = rng.normal(size=(2, 4)).astype(np.float32), np.ones(2)
    idf = IDFModel().set_input_col("f").set_output_col("t")
    idf.idf, idf.doc_freq, idf.num_docs = np.ones(D_SPARSE), np.ones(D_SPARSE), np.asarray(3.0)
    imp = ImputerModel().set_input_cols("s").set_output_cols("t")
    imp.surrogates = np.asarray([2.5])
    stages = {"idf_model": idf, "lr_model": lr, "scaler_model": scaler, "mlp_model": mlp, "kmeans_model": km,
              "imputer_model": imp}
    attn = SelfAttentionClassifierModel()
    rng = np.random.default_rng(7)
    attn.params = {"embedding": rng.normal(size=(16, 8)).astype(np.float32)}
    attn.labels = np.arange(2.0)
    stages.update({
        "attention_model": attn,
        "normalizer": Normalizer().set_p(3.0),
        "product": ElementwiseProduct().set_scaling_vec(DenseVector(np.arange(1.0, 5.0))),
        "binarizer": Binarizer().set_input_cols("x").set_output_cols("y").set_thresholds(0.2),
        "pipeline": Pipeline([StandardScaler(), KMeans().set_k(2)]),
        "pipeline_model": PipelineModel([stages["scaler_model"], Normalizer()]),
        "scaler": StandardScaler(), "kmeans": KMeans(), "mlp": MLPClassifier(), "lr": LogisticRegression(),
        "idf": IDF(), "imputer": Imputer(), "attention": SelfAttentionClassifier(),
    })
    cv = CountVectorizerModel().set_input_col("tok").set_min_tf(0.5).set_binary(True)
    cv.vocabulary = ["b", "a", "😀", "c d"]
    stages.update({
        "tokenizer": Tokenizer().set_input_col("s").set_output_col("tok"),
        "regex_tokenizer": RegexTokenizer().set_pattern(r"\w+").set_gaps(False).set_min_token_length(2),
        "stop_words_remover": StopWordsRemover().set_input_cols("tok").set_output_cols("kept")
        .set_stop_words("a", "the").set_case_sensitive(True),
        "ngram": NGram().set_n(3),
        "hashing_tf": HashingTF().set_num_features(1000).set_binary(True),
        "feature_hasher": FeatureHasher().set_input_cols("x", "c").set_categorical_cols("c"),
        "count_vectorizer_model": cv,
        "count_vectorizer": CountVectorizer().set_min_df(0.5).set_max_df(3.0).set_vocabulary_size(7),
    })
    # the online stages: the model version, the scaler's timestamp and its
    # buffered rows (sparse cells among them) travel with the model data
    online_lr = OnlineLogisticRegressionModel().set_features_col("x").set_model_version_col("v")
    online_lr.coefficient, online_lr.model_version = rng.normal(size=4).astype(np.float32), 7
    online_km = OnlineKMeansModel().set_features_col("x").set_k(2)
    online_km.centroids, online_km.weights = rng.normal(size=(2, 4)).astype(np.float32), np.asarray([3.0, 0.5])
    online_km.model_version = 3
    online_sc = OnlineStandardScalerModel().set_input_col("x").set_max_allowed_model_delay_ms(20)
    online_sc.mean, online_sc.std = rng.normal(size=2), np.abs(rng.normal(size=2))
    online_sc.model_version, online_sc.model_timestamp = 2, 250.0
    online_sc._pending = [
        DataFrame.from_dict({"x": rng.normal(size=(2, 2)), TIMESTAMP_COL: np.asarray([300.0, 310.0])}),
        DataFrame(["x", TIMESTAMP_COL], None, [[SparseVector(2, [1], [7.0])], np.asarray([400.0])]),
    ]
    stages.update({
        "online_lr_model": online_lr, "online_kmeans_model": online_km, "online_scaler_model": online_sc,
        "online_lr": OnlineLogisticRegression().set_alpha(0.4).set_reg(0.01).set_elastic_net(0.5),
        "online_kmeans": OnlineKMeans().set_k(3).set_decay_factor(0.5),
        "online_scaler": OnlineStandardScaler().set_windows(EventTimeTumblingWindows.of(1000))
        .set_max_allowed_model_delay_ms(500),
    })
    jax_classes = {
        "idf_model": JIDFModel, "lr_model": JLogisticRegressionModel, "scaler_model": JStandardScalerModel,
        "mlp_model": JMLPClassifierModel, "kmeans_model": JKMeansModel, "imputer_model": JImputerModel,
        "attention_model": JAttnModel, "normalizer": JNormalizer, "product": JProduct, "binarizer": JBinarizer,
        "pipeline": JPipeline, "pipeline_model": JPipelineModel, "scaler": JStandardScaler, "kmeans": JKMeans,
        "mlp": JMLP, "lr": JLR, "idf": JIDF, "imputer": JImputer, "attention": JAttn,
        "tokenizer": JTokenizer, "regex_tokenizer": JRegexTokenizer, "stop_words_remover": JStopWordsRemover,
        "ngram": JNGram, "hashing_tf": JHashingTF, "feature_hasher": JFeatureHasher,
        "count_vectorizer_model": JCountVectorizerModel, "count_vectorizer": JCountVectorizer,
        "online_lr_model": JOnlineLRModel, "online_kmeans_model": JOnlineKMeansModel,
        "online_scaler_model": JOnlineScalerModel, "online_lr": JOnlineLR, "online_kmeans": JOnlineKMeans,
        "online_scaler": JOnlineScaler,
    }
    return stages, jax_classes


def _json(stage):
    """A stage's params as JSON text: a NaN placeholder compares equal."""
    import json

    return json.dumps(stage.param_map_to_json(), sort_keys=True)


def _online_state(stage):
    """An online model's version, timestamp and buffered rows (each cell of
    a vector column as its dense values); None for any other stage."""
    if not hasattr(stage, "model_version"):
        return None
    pending = [[(name, [np.asarray(c.to_array() if hasattr(c, "to_array") else c, np.float64).tolist()
                        for c in frame.column(name)]) for name in frame.get_column_names()]
               for frame in getattr(stage, "_pending", [])]
    return stage.model_version, getattr(stage, "model_timestamp", None), pending


def test_every_port_stage_saved_loads_in_the_jax_package(tmp_path):
    """Every port stage with a ``save`` writes its JAX twin's class name: the
    JAX ``load`` and ``load_stage`` read the directory as a ``flink_ml_tpu``
    class with the same params, and the port still loads it."""
    stages, jax_classes = _every_port_stage()
    assert set(stages) == set(jax_classes)
    for name, stage in stages.items():
        path = str(tmp_path / name)
        stage.save(path)
        meta = jrw.load_metadata(path)
        assert meta["className"] == rw.jax_class_name(stage) and meta["className"].startswith("flink_ml_tpu.")
        jcls = jax_classes[name]
        for loaded in (jcls.load(path), jrw.load_stage(path)):
            assert type(loaded) is jcls, name
            assert type(loaded).__module__.startswith("flink_ml_tpu."), name
            assert _json(loaded) == _json(stage), name
            assert getattr(loaded, "vocabulary", None) == getattr(stage, "vocabulary", None), name
            assert _online_state(loaded) == _online_state(stage), name
        back = type(stage).load(path)
        assert type(back) is type(stage) and _json(back) == _json(stage), name
        assert _online_state(back) == _online_state(stage), name
        assert getattr(back, "vocabulary", None) == getattr(stage, "vocabulary", None), name
        assert type(rw.load_stage(path)) is type(stage), name


def test_the_port_still_loads_directories_that_hold_port_class_names(tmp_path):
    """Directories written before the port wrote JAX names hold its own
    class names: ``load``, ``load_stage`` and ``load_servable`` read them."""
    import json

    from flink_ml_tpu_torch.servable import StandardScalerModelServable, load_servable

    stages, _ = _every_port_stage()
    for name in ("scaler_model", "kmeans_model", "pipeline_model", "binarizer"):
        stage = stages[name]
        path = str(tmp_path / name)
        stage.save(path)
        for root, _dirs, files in os.walk(path):  # rewrite every metadata file with the port's name
            if "metadata" in files:
                with open(os.path.join(root, "metadata")) as f:
                    meta = json.load(f)
                twin = meta["className"]
                meta["className"] = "flink_ml_tpu_torch." + twin[len("flink_ml_tpu."):]
                with open(os.path.join(root, "metadata"), "w") as f:
                    json.dump(meta, f)
        assert type(type(stage).load(path)) is type(stage), name
        assert type(rw.load_stage(path)) is type(stage), name
    assert isinstance(load_servable(str(tmp_path / "scaler_model")), StandardScalerModelServable)


def test_a_stage_without_a_jax_twin_is_refused_by_name(tmp_path):
    from flink_ml_tpu_torch.api.core import Transformer

    class Orphan(Transformer):
        pass

    with pytest.raises(ValueError, match="Orphan has no JAX twin"):
        Orphan().save(str(tmp_path / "orphan"))
    assert not os.path.exists(os.path.join(tmp_path, "orphan", "metadata"))
