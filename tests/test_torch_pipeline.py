"""The port's Pipeline slice against the JAX package on the CPU: the
``DataFrame`` members it needs, ``Pipeline.fit``, ``PipelineModel.transform``
through the batch plan (``builder/batch_plan.py``) and per stage, save/load
both ways, ``PipelineModel.load_servable`` serving, and the new megakernel
chains the path produces — ``("scale", "normalize", "kmeans")``,
``("normalize", "mlp")``, ``("sparse_idf",)`` — in both plan tiers against the
JAX megakernel in Pallas interpret mode, with the cost model's choice per
bucket. Tests of the CUDA kernels themselves are in ``test_torch_gpu.py``.

The batch plan's own contracts mirror ``tests/test_batch_fastpath.py``
wherever the ported stages allow; a KMeansModel, which has no kernel spec in
either package, takes the place of the spec-less stage that breaks a segment.

Tolerances, each with its reason:
- fused against per-stage inside the port: bit-exact in the exact tier (the
  same ``ops/kernels`` bodies on the same float32 tensors);
- against the JAX package's batch and per-stage results: within 1024 ulps
  (the fast tier's feature6 envelope; XLA and PyTorch sum a normalize's row
  in other orders), a binarize compared outside a 1e-5 margin of its
  threshold;
- KMeans assignments equal wherever the float64 top-two distance gap
  exceeds 1e-4, the fitted centroids within atol 1e-5
  (``test_torch_kmeans.py``);
- the MLP fit's probabilities within atol 1e-5, predictions equal past a
  1e-4 logit gap (``test_torch_mlp.py``);
- the scaler's fitted mean and std within rtol 1e-6 (``test_torch_mlp.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame, Row as JRow
from flink_ml_tpu.builder.pipeline import Pipeline as JPipeline, PipelineModel as JPipelineModel
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.logistic_regression import (
    LogisticRegressionModel as JLogisticRegressionModel,
)
from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifier as JMLPClassifier
from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
from flink_ml_tpu.models.feature.binarizer import Binarizer as JBinarizer
from flink_ml_tpu.models.feature.elementwise_product import ElementwiseProduct as JElementwiseProduct
from flink_ml_tpu.models.feature.idf import IDFModel as JIDFModel
from flink_ml_tpu.models.feature.normalizer import Normalizer as JNormalizer
from flink_ml_tpu.models.feature.standard_scaler import (
    StandardScaler as JStandardScaler,
    StandardScalerModel as JStandardScalerModel,
)
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipelineServable
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.servable.megakernels import chain_eligible as jax_chain_eligible
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch.api.dataframe import DataFrame, Row
from flink_ml_tpu_torch.builder import CompiledBatchPlan, Pipeline, PipelineModel
from flink_ml_tpu_torch.builder.batch_plan import BatchPlanInapplicable
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans, KMeansModel
from flink_ml_tpu_torch.models.feature.binarizer import Binarizer
from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct
from flink_ml_tpu_torch.models.feature.idf import IDFModel
from flink_ml_tpu_torch.models.feature.imputer import ImputerModel
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler, StandardScalerModel
from flink_ml_tpu_torch.servable import (
    KMeansModelServable,
    MLPClassifierModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier, chain_score, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import chain_eligible
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

SCOPE = "ml.batch[plan]"
N = 203  # odd: 3 chunks of 64 and a ragged tail under BATCH_CHUNK_ROWS 64
ENVELOPE = ULP_ENVELOPE["feature6"]
BIN_MARGIN = 1e-5
KMEANS_MARGIN = 1e-4
MLP_MARGIN = 1e-4
CENTROID_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets is unset after it, in both packages:
    the test workers run other files in the same process."""
    yield
    for option in (Options.BATCH_FASTPATH, Options.BATCH_CHUNK_ROWS, Options.BATCH_PREFETCH_DEPTH,
                   Options.BATCH_MESH, Options.BATCH_MESH_MODEL, Options.FUSION_MODE,
                   Options.FUSION_MEGAKERNEL_MIN_SCORE, Options.SPARSE_FASTPATH):
        config.unset(option)
    for option in (JOptions.BATCH_FASTPATH, JOptions.BATCH_CHUNK_ROWS, JOptions.BATCH_PREFETCH_DEPTH,
                   JOptions.FUSION_MODE, JOptions.FUSION_MEGAKERNEL_MIN_SCORE):
        jconfig.unset(option)


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


def _vec_df(n, d, seed=7, cls=DataFrame):
    return cls.from_dict({"input": np.random.default_rng(seed).normal(size=(n, d))})


def _assert_frames_bitexact(a, b):
    assert a.get_column_names() == b.get_column_names()
    for name in a.get_column_names():
        ca, cb = a.column(name), b.column(name)
        if isinstance(ca, np.ndarray) or isinstance(cb, np.ndarray):
            ca, cb = np.asarray(ca), np.asarray(cb)
            assert ca.dtype == cb.dtype, (name, ca.dtype, cb.dtype)
            np.testing.assert_array_equal(ca, cb, err_msg=name)
        else:
            assert len(ca) == len(cb), name
            for va, vb in zip(ca, cb):
                np.testing.assert_array_equal(np.asarray(va.to_array()), np.asarray(vb.to_array()))


def _transform_both(model, df):
    """(per-stage result, batch-plan result) on the CPU, asserting the second
    rode a plan."""
    config.set(Options.BATCH_FASTPATH, False)
    slow = model.transform(df, device="cpu")
    config.set(Options.BATCH_FASTPATH, True)
    model.invalidate_batch_plan()
    before = metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0)
    fast = model.transform(df, device="cpu")
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0) >= before + len(df)
    return slow, fast


# ---------------------------------------------------------------------------
# the DataFrame members
# ---------------------------------------------------------------------------


def _cells_equal(a, b):
    if hasattr(a, "to_array"):
        return np.array_equal(np.asarray(a.to_array()), np.asarray(b.to_array()))
    return a == b and type(a) is type(b)


def test_rows_and_schema_members_match_jax():
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(4, 3))
    rows = [(float(i), int(i), vecs[i], f"s{i}", bool(i % 2)) for i in range(4)]
    names = ["d", "l", "v", "s", "b"]
    df = DataFrame.from_rows(names, [Row(list(rows[0]))] + [list(r) for r in rows[1:]])
    jdf = JDataFrame.from_rows(names, [JRow(list(rows[0]))] + [list(r) for r in rows[1:]])
    assert df.column_names == jdf.column_names == names
    for name in names:
        assert str(df.get_data_type(name)) == str(jdf.get_data_type(name)), name
    got, want = df.collect(), jdf.collect()
    assert len(got) == len(want) == 4
    for r, jr in zip(got, want):
        assert r.size() == jr.size() == 5
        assert all(_cells_equal(a, b) for a, b in zip(r.values, jr.values)), (r, jr)
    assert isinstance(got[0].get(2), DenseVector)
    assert Row([1, np.ones(2)]) == Row([1, np.ones(2)]) and Row([1]) != Row([2])
    empty, jempty = DataFrame.from_rows(["a", "b"], []), JDataFrame.from_rows(["a", "b"], [])
    assert len(empty) == len(jempty) == 0 and empty.collect() == [] == jempty.collect()
    sparse = [SparseVector(5, np.array([1, 3]), np.array([0.5, -1.0]))]
    jsparse = [JSparseVector(5, np.array([1, 3]), np.array([0.5, -1.0]))]
    cell, jcell = DataFrame.from_rows(["x"], [sparse]).collect()[0][0], \
        JDataFrame.from_rows(["x"], [jsparse]).collect()[0][0]
    assert _cells_equal(cell, jcell)


def test_with_column_select_drop_match_jax():
    X = np.random.default_rng(4).normal(size=(5, 2))
    df = DataFrame.from_dict({"a": X, "b": np.arange(5.0), "c": [f"r{i}" for i in range(5)]})
    jdf = JDataFrame.from_dict({"a": X, "b": np.arange(5.0), "c": [f"r{i}" for i in range(5)]})
    out, jout = df.with_column("d", np.arange(5)), jdf.with_column("d", np.arange(5))
    assert out.column_names == jout.column_names == ["a", "b", "c", "d"]
    assert df.column_names == ["a", "b", "c"]  # the original is left as it is
    assert str(out.get_data_type("d")) == str(jout.get_data_type("d"))
    replaced, jreplaced = out.with_column("b", -np.arange(5.0)), jout.with_column("b", -np.arange(5.0))
    np.testing.assert_array_equal(replaced.column("b"), jreplaced.column("b"))
    assert replaced.column_names == jreplaced.column_names
    sel, jsel = out.select(["d", "a"]), jout.select(["d", "a"])
    assert sel.column_names == jsel.column_names == ["d", "a"]
    np.testing.assert_array_equal(sel.column("a"), jsel.column("a"))
    dropped, jdropped = out.drop("a", "c"), jout.drop("a", "c")
    assert dropped.column_names == jdropped.column_names == ["b", "d"]
    with pytest.raises(ValueError):
        out.select(["nope"])
    assert out.drop("nope").column_names == out.column_names


# ---------------------------------------------------------------------------
# Pipeline.fit against the JAX Pipeline.fit
# ---------------------------------------------------------------------------


def _blobs(n, d, k, seed, fit_seed=11):
    """Rows around k well-separated centres, laid out so the rows a KMeans
    fit with ``fit_seed`` draws as its first centroids lie one in each blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 10.0
    labels = rng.integers(0, k, size=n)
    labels[np.random.default_rng(fit_seed).choice(n, size=k, replace=False)] = np.arange(k)
    return centres[labels] + rng.normal(size=(n, d)) * 0.05


def _kmeans_stages(scaler_cls, normalizer_cls, kmeans_cls, k=3, iters=5):
    return [
        scaler_cls().set_input_col("features").set_output_col("scaled").set_with_mean(True),
        normalizer_cls().set_input_col("scaled").set_output_col("norm").set_p(2.0),
        kmeans_cls().set_features_col("norm").set_k(k).set_max_iter(iters).set_seed(11),
    ]


def _pairwise64(X, C):
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    return np.sqrt(np.sum((X[:, None, :] - C[None, :, :]) ** 2, axis=-1))


def _decided(X, C):
    top = np.sort(_pairwise64(X, C), axis=1)
    return top[:, 1] - top[:, 0] > KMEANS_MARGIN


def test_pipeline_fit_scaler_normalizer_kmeans_matches_jax(one_device_mesh):
    X = _blobs(300, 8, 3, seed=5)
    model = Pipeline(_kmeans_stages(StandardScaler, Normalizer, KMeans)).fit(
        DataFrame.from_dict({"features": X}), device="cpu")
    jmodel = JPipeline(_kmeans_stages(JStandardScaler, JNormalizer, JKMeans)).fit(
        JDataFrame.from_dict({"features": X}))
    assert isinstance(model, PipelineModel)
    assert [type(s).__name__ for s in model.stages] == [type(s).__name__ for s in jmodel.stages] \
        == ["StandardScalerModel", "Normalizer", "KMeansModel"]
    (sc, _norm, km), (jsc, _jnorm, jkm) = model.stages, jmodel.stages
    np.testing.assert_allclose(sc.mean, jsc.mean, rtol=1e-6)
    np.testing.assert_allclose(sc.std, jsc.std, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(km.centroids, jkm.centroids, rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(km.weights, jkm.weights)
    assert [s.param_map_to_json() for s in model.stages] == [s.param_map_to_json() for s in jmodel.stages]
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    assert ulp_diff(out.column("norm"), np.asarray(ref.column("norm"))) <= ENVELOPE
    decided = _decided(out.column("norm"), km.centroids)
    assert decided.all()  # the blobs are far apart
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))


def _mlp_data(n, d, classes, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=1.0, scale=2.0, size=(n, d))
    y = np.argmax(X @ rng.normal(size=(d, classes)), axis=1).astype(np.float64) * 2.0 + 1.0
    return X, y


def _logits(layers, X):
    h = np.asarray(X, np.float64)
    for W, b in layers[:-1]:
        h = np.maximum(h @ W + b, 0.0)
    return h @ layers[-1][0] + layers[-1][1]


def test_pipeline_fit_normalizer_mlp_matches_jax(one_device_mesh):
    X, y = _mlp_data(400, 16, 4, seed=7)

    def stages(norm_cls, mlp_cls):
        mlp = (mlp_cls().set_features_col("norm").set_hidden_layers(32, 32).set_max_iter(6)
               .set_global_batch_size(128).set_learning_rate(0.05).set_tol(0.0).set_seed(11))
        return [norm_cls().set_input_col("features").set_output_col("norm").set_p(2.0), mlp]

    model = Pipeline(stages(Normalizer, MLPClassifier)).fit(
        DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    jmodel = JPipeline(stages(JNormalizer, JMLPClassifier)).fit(
        JDataFrame.from_dict({"features": X, "label": y}))
    mlp, jmlp = model.stages[1], jmodel.stages[1]
    assert mlp.param_map_to_json() == jmlp.param_map_to_json()
    np.testing.assert_array_equal(mlp.labels, jmlp.labels)
    X_new = np.random.default_rng(8).normal(loc=1.0, scale=2.0, size=(97, 16))
    out = model.transform(DataFrame.from_dict({"features": X_new}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X_new}))
    np.testing.assert_allclose(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction")),
                               rtol=0, atol=1e-5)
    norm64 = np.asarray(ref.column("norm"), np.float64)
    logits = _logits([(np.asarray(W, np.float64), np.asarray(b, np.float64)) for W, b in jmlp.params],
                     norm64)
    top = np.sort(logits, axis=1)
    decided = top[:, -1] - top[:, -2] > MLP_MARGIN
    np.testing.assert_array_equal(out.column("prediction")[decided],
                                  np.asarray(ref.column("prediction"))[decided])


class _Counting(Normalizer):
    """A Normalizer that counts its transforms."""

    calls = 0

    def transform(self, *inputs, device=None):
        type(self).calls += 1
        return super().transform(*inputs, device=device)


def test_fit_does_not_transform_stages_at_or_after_the_last_estimator():
    X = _blobs(60, 4, 2, seed=1)
    _Counting.calls = 0
    before = _Counting().set_input_col("features").set_output_col("n1")
    after = _Counting().set_input_col("features").set_output_col("n2")
    scaler = StandardScaler().set_input_col("n1").set_output_col("scaled")
    model = Pipeline([before, scaler, after]).fit(DataFrame.from_dict({"features": X}), device="cpu")
    assert _Counting.calls == 1  # only the stage before the last Estimator
    assert model.stages[0] is before and model.stages[2] is after
    assert isinstance(model.stages[1], StandardScalerModel)
    _Counting.calls = 0
    Pipeline([before, after]).fit(DataFrame.from_dict({"features": X}), device="cpu")
    assert _Counting.calls == 0  # no Estimator: nothing is transformed


# ---------------------------------------------------------------------------
# the batch plan's own contracts (tests/test_batch_fastpath.py)
# ---------------------------------------------------------------------------


def _scaler(d, seed=0, cls=StandardScalerModel):
    rng = np.random.default_rng(seed)
    m = cls().set_input_col("input").set_output_col("output")
    m.set_with_mean(True)
    m.mean = rng.normal(size=d)
    m.std = np.abs(rng.normal(size=d)) + 0.5
    m.std[min(1, d - 1)] = 0.0  # the zero-std guard in both paths
    return m


def _imputer_model(cols, seed=3):
    m = ImputerModel().set_input_cols(*cols).set_output_cols(*[f"{c}_f" for c in cols])
    m.surrogates = np.random.default_rng(seed).normal(size=len(cols))
    return m


def _idf_model(d, seed=5):
    m = IDFModel().set_input_col("input").set_output_col("output")
    m.idf = np.abs(np.random.default_rng(seed).normal(size=d))
    m.doc_freq, m.num_docs = np.ones(d), np.asarray(100.0)
    return m


def _case_imputer(_d):
    rng = np.random.default_rng(6)
    cols = {f"c{i}": rng.normal(size=N) for i in range(3)}
    for c in cols.values():
        c[rng.random(N) < 0.2] = np.nan
    return _imputer_model(list(cols)), DataFrame.from_dict(cols)


CASES = {
    "binarizer": lambda d: (Binarizer().set_input_cols("input").set_output_cols("output")
                            .set_thresholds(0.1), _vec_df(N, d)),
    "normalizer": lambda d: (Normalizer().set_input_col("input").set_output_col("output").set_p(3.0),
                             _vec_df(N, d)),
    "elementwise": lambda d: (ElementwiseProduct().set_scaling_vec(np.random.default_rng(9).normal(size=d))
                              .set_input_col("input").set_output_col("output"), _vec_df(N, d)),
    "scaler": lambda d: (_scaler(d), _vec_df(N, d)),
    "idf": lambda d: (_idf_model(d), _vec_df(N, d)),
    "imputer": _case_imputer,
}


@pytest.mark.parametrize("width", (1, 8, 100))
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_matches_per_stage_bitexact(name, width):
    stage, df = CASES[name](width)
    slow, fast = _transform_both(PipelineModel([stage]), df)
    _assert_frames_bitexact(slow, fast)


def _chain(d=16, cls=None):
    """scaler → normalizer → product → binarizer, in the port or (``cls`` a
    dict of JAX classes) the JAX package."""
    cls = cls or {"scaler": StandardScalerModel, "norm": Normalizer, "prod": ElementwiseProduct,
                  "bin": Binarizer}
    rng = np.random.default_rng(21)
    scaler = _scaler(d, cls=cls["scaler"]).set_output_col("scaled")
    return [
        scaler,
        cls["norm"]().set_input_col("scaled").set_output_col("norm"),
        cls["prod"]().set_scaling_vec(rng.normal(size=d)).set_input_col("norm").set_output_col("prod"),
        cls["bin"]().set_input_cols("prod").set_output_cols("bin").set_thresholds(0.05),
    ]


_JAX_CHAIN = {"scaler": JStandardScalerModel, "norm": JNormalizer, "prod": JElementwiseProduct,
              "bin": JBinarizer}


def test_four_stage_chain_fused_bitexact():
    model = PipelineModel(_chain())
    slow, fast = _transform_both(model, _vec_df(N, 16))
    _assert_frames_bitexact(slow, fast)
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_STAGES) == 4
    assert metrics.get(SCOPE, MLMetrics.BATCH_FALLBACK_STAGES) == 0


def _kmeans_model(d, k=3, seed=8, col="norm"):
    m = KMeansModel().set_features_col(col).set_k(k)
    m.centroids = np.random.default_rng(seed).normal(size=(k, d)).astype(np.float32)
    m.weights = np.ones(k)
    return m


def test_mixed_chain_spec_less_stage_breaks_segment_bitexact():
    stages = _chain()
    stages.insert(2, _kmeans_model(16))  # scaler + normalizer | kmeans | product + binarizer
    assert not hasattr(stages[2], "kernel_spec")  # no spec, as in the JAX package
    model = PipelineModel(stages)
    before = metrics.get(SCOPE, MLMetrics.fallback_reason("batch", "specless"), 0)
    slow, fast = _transform_both(model, _vec_df(N, 16))
    _assert_frames_bitexact(slow, fast)
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_STAGES) == 4
    assert metrics.get(SCOPE, MLMetrics.BATCH_FALLBACK_STAGES) == 1
    assert metrics.get(SCOPE, MLMetrics.fallback_reason("batch", "specless"), 0) == before + 1


def test_sparse_input_falls_back_bitexact():
    rng = np.random.default_rng(22)
    vecs = [SparseVector(16, np.sort(rng.choice(16, size=4, replace=False)), rng.normal(size=4))
            for _ in range(24)]
    df = DataFrame(["input"], None, [vecs])
    stage = (ElementwiseProduct().set_scaling_vec(rng.normal(size=16))
             .set_input_col("input").set_output_col("output"))
    model = PipelineModel([stage])
    config.set(Options.BATCH_FASTPATH, False)
    slow = model.transform(df, device="cpu")
    config.set(Options.BATCH_FASTPATH, True)
    before = metrics.get(SCOPE, MLMetrics.BATCH_FALLBACK_SEGMENTS, 0)
    sparse_before = metrics.get(SCOPE, MLMetrics.fallback_reason("batch", "sparse"), 0)
    fast = model.transform(df, device="cpu")
    assert metrics.get(SCOPE, MLMetrics.BATCH_FALLBACK_SEGMENTS, 0) == before + 1
    assert metrics.get(SCOPE, MLMetrics.fallback_reason("batch", "sparse"), 0) == sparse_before + 1
    _assert_frames_bitexact(slow, fast)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_chunked_prefetch_depths_bitexact(depth):
    model = PipelineModel(_chain())
    df = _vec_df(N, 16)
    config.set(Options.BATCH_FASTPATH, False)
    slow = model.transform(df, device="cpu")
    config.set(Options.BATCH_FASTPATH, True)
    config.set(Options.BATCH_CHUNK_ROWS, 64)  # 203 rows → 3 full + 1 remainder
    config.set(Options.BATCH_PREFETCH_DEPTH, depth)
    model.invalidate_batch_plan()
    before_chunks = metrics.get(SCOPE, MLMetrics.BATCH_FUSED_CHUNKS, 0)
    fast = model.transform(df, device="cpu")
    _assert_frames_bitexact(slow, fast)
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_CHUNKS, 0) == before_chunks + 4


def test_chunked_builds_once_per_signature_and_reuses_the_plan_across_calls():
    model = PipelineModel(_chain())
    df = _vec_df(200, 16)
    config.set(Options.BATCH_FASTPATH, True)
    config.set(Options.BATCH_CHUNK_ROWS, 64)  # 3×64 + 8: two distinct signatures
    before = metrics.get(SCOPE, MLMetrics.BATCH_COMPILES, 0)
    model.transform(df, device="cpu")
    assert metrics.get(SCOPE, MLMetrics.BATCH_COMPILES, 0) == before + 2
    plan = model._plan_cache[1]
    model.transform(df, device="cpu")  # same plan, same signatures: nothing new built
    assert metrics.get(SCOPE, MLMetrics.BATCH_COMPILES, 0) == before + 2
    assert model._plan_cache[1] is plan
    (segment,) = plan.segments
    assert len(segment.compiled) == 2
    assert {segment.plan_label(key) for key in segment.compiled} == {"exact"}
    hist = metrics.get(SCOPE, MLMetrics.BATCH_CHUNK_MS)
    assert hist is not None and hist.count >= 8


def test_set_model_data_invalidates_the_cached_plan():
    d = 8
    model = PipelineModel([_scaler(d)])
    df = _vec_df(32, d)
    config.set(Options.BATCH_FASTPATH, True)
    out1 = model.transform(df, device="cpu")
    replacement = _scaler(d, seed=99)
    model.set_model_data(*replacement.get_model_data())
    assert model._plan_cache is None
    out2 = model.transform(df, device="cpu")
    assert not np.array_equal(out1.column("output"), out2.column("output"))
    config.set(Options.BATCH_FASTPATH, False)
    _assert_frames_bitexact(model.transform(df, device="cpu"), out2)
    assert len(model.get_model_data()) == len(replacement.get_model_data())


def test_param_change_refreshes_the_plan():
    stage = Normalizer().set_p(2.0).set_input_col("input").set_output_col("output")
    model = PipelineModel([stage])
    df = _vec_df(32, 8)
    config.set(Options.BATCH_FASTPATH, True)
    out2 = model.transform(df, device="cpu")
    stage.set_p(1.0)
    out1 = model.transform(df, device="cpu")
    assert not np.array_equal(out2.column("output"), out1.column("output"))
    config.set(Options.BATCH_FASTPATH, False)
    _assert_frames_bitexact(model.transform(df, device="cpu"), out1)


def test_fastpath_off_is_the_per_stage_path():
    model = PipelineModel(_chain())
    df = _vec_df(40, 16)
    config.set(Options.BATCH_FASTPATH, False)
    before = metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0)
    model.transform(df, device="cpu")
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0) == before
    assert model._plan_cache is None


def test_empty_frame_runs_per_stage():
    model = PipelineModel([Normalizer().set_input_col("input").set_output_col("output")])
    df = DataFrame.from_dict({"input": np.zeros((0, 4))})
    config.set(Options.BATCH_FASTPATH, True)
    before = metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0)
    out = model.transform(df, device="cpu")
    assert len(out) == 0 and "output" in out.get_column_names()
    assert metrics.get(SCOPE, MLMetrics.BATCH_FUSED_ROWS, 0) == before


def test_elementwise_runs_merge_reduction_specs_stay_solo():
    d = 16
    rng = np.random.default_rng(41)
    scaler = _scaler(d).set_output_col("scaled")
    ep = ElementwiseProduct().set_scaling_vec(rng.normal(size=d)).set_input_col("norm").set_output_col("prod")
    binz = Binarizer().set_input_cols("prod").set_output_cols("bin").set_thresholds(0.1)
    norm = Normalizer().set_input_col("scaled").set_output_col("norm")
    plan = CompiledBatchPlan.build([scaler, norm, ep, binz], device="cpu")
    (segment,) = plan.segments
    assert [len(p.specs) for p in segment.programs] == [1, 1, 2]
    fast = CompiledBatchPlan.build([scaler, norm, ep, binz], device="cpu", fusion=FusionTier("fast"))
    assert [len(p.specs) for p in fast.segments[0].programs] == [4]


def test_no_spec_builds_no_plan_and_a_multi_output_stage_gives_way():
    assert CompiledBatchPlan.build([_kmeans_model(4, col="input")], device="cpu") is None

    class _TwoOut(Normalizer):
        def transform(self, *inputs, device=None):
            out = super().transform(*inputs, device=device)
            return [out, out]

        def kernel_spec(self):
            return None

    model = PipelineModel([Normalizer().set_input_col("input").set_output_col("n"),
                           _TwoOut().set_input_col("n").set_output_col("m")])
    config.set(Options.BATCH_FASTPATH, True)
    with pytest.raises(BatchPlanInapplicable):
        model._batch_plan(_vec_df(8, 4), torch.device("cpu")).transform(_vec_df(8, 4))
    out = model.transform(_vec_df(8, 4), device="cpu")  # the per-stage path takes over
    assert isinstance(out, list) and len(out) == 2


def test_batch_mesh_other_than_one_raises():
    """``batch.mesh`` / ``batch.mesh.model`` 2 no longer raise: the plan
    rebuilds on a 2-shard grid and its rows are bit-equal to mesh 1 (the
    16-wide chain holds no array the model axis splits)."""
    model = PipelineModel(_chain())
    df = _vec_df(40, 16)
    base = model.transform(df, device="cpu")
    assert model._plan_cache[1].sharding is None
    for option, key in ((Options.BATCH_MESH, (2, 1)), (Options.BATCH_MESH_MODEL, (1, 2))):
        config.set(option, 2)
        try:
            out = model.transform(df, device="cpu")
            assert model._plan_cache[1].sharding.key == key
        finally:
            config.unset(option)
        for name in base.get_column_names():
            np.testing.assert_array_equal(np.asarray(out[name]), np.asarray(base[name]), err_msg=name)
    assert Options.BATCH_MESH.default == Options.BATCH_MESH_MODEL.default == 1
    assert (Options.BATCH_MESH.default, Options.BATCH_MESH_MODEL.default) == (
        JOptions.BATCH_MESH.default, JOptions.BATCH_MESH_MODEL.default)
    assert (Options.BATCH_FASTPATH.default, Options.BATCH_CHUNK_ROWS.default,
            Options.BATCH_PREFETCH_DEPTH.default) == (JOptions.BATCH_FASTPATH.default,
                                                      JOptions.BATCH_CHUNK_ROWS.default,
                                                      JOptions.BATCH_PREFETCH_DEPTH.default)


def test_transform_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        PipelineModel(_chain()).transform(_vec_df(8, 16))
    with pytest.raises(RuntimeError):
        Pipeline([StandardScaler().set_input_col("input")]).fit(_vec_df(8, 16))


# ---------------------------------------------------------------------------
# the batch plan against the JAX package
# ---------------------------------------------------------------------------


def _assert_close_to_jax(out, ref, names, bin_inputs=()):
    """Columns within ENVELOPE ulps; a binarize output equal outside
    BIN_MARGIN of its threshold (``bin_inputs``: name → (input, threshold))."""
    bin_inputs = dict(bin_inputs)
    for name in names:
        got, want = np.asarray(out.column(name)), np.asarray(ref.column(name))
        if name in bin_inputs:
            src, threshold = bin_inputs[name]
            far = np.abs(np.asarray(ref.column(src)) - threshold) > BIN_MARGIN
            np.testing.assert_array_equal(got[far], want[far], err_msg=name)
        else:
            assert ulp_diff(got, want) <= ENVELOPE, name


@pytest.mark.parametrize("mode", ("exact", "fast"))
def test_batch_transform_matches_the_jax_pipeline_model(mode):
    config.set(Options.FUSION_MODE, mode)
    jconfig.set(JOptions.FUSION_MODE, mode)
    config.set(Options.BATCH_CHUNK_ROWS, 64)
    jconfig.set(JOptions.BATCH_CHUNK_ROWS, 64)
    model, jmodel = PipelineModel(_chain()), JPipelineModel(_chain(cls=_JAX_CHAIN))
    out = model.transform(_vec_df(N, 16), device="cpu")
    ref = jmodel.transform(_vec_df(N, 16, cls=JDataFrame))
    assert out.get_column_names() == ref.get_column_names()
    _assert_close_to_jax(out, ref, ("scaled", "norm", "prod", "bin"), {"bin": ("prod", 0.05)})
    np.testing.assert_array_equal(out.column("scaled"), np.asarray(ref.column("scaled")))
    (segment,) = model._plan_cache[1].segments
    labels = {segment.plan_label(key) for key in segment.compiled}
    assert labels == ({"exact"} if mode == "exact" else {"fast"})


def _sparse_rows(n, d, nnz, seed, cls):
    """SparseVector rows of 1–nnz sorted ids in [0, d) and values in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.integers(1, nnz + 1, size=n):
        ids = np.sort(rng.choice(d, size=int(k), replace=False))
        out.append(cls(d, ids, rng.random(int(k)) + 0.5))
    return out


def _idf_lr(d, seed, idf_cls, lr_cls):
    rng = np.random.default_rng(seed)
    idf = idf_cls().set_input_col("features").set_output_col("tfidf")
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=d)) + 0.1, np.ones(d), np.asarray(50.0)
    lr = lr_cls().set_features_col("tfidf")
    lr.coefficient = rng.normal(size=d) * 0.3
    return [idf, lr]


@pytest.mark.parametrize("mode", ("exact", "fast"))
def test_sparse_idf_lr_batch_matches_the_jax_batch_plan(mode):
    """IDF → LogisticRegression on a SparseVector column: the LR model's
    sparse spec fuses it as ("sparse_idf", "sparse_logistic") in the batch
    tier of both packages; the tf-idf values and the margin's sequential
    fold agree bit for bit, the probabilities within the sparse envelope."""
    d = 1000
    config.set(Options.FUSION_MODE, mode)
    jconfig.set(JOptions.FUSION_MODE, mode)
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    jconfig.set(JOptions.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    config.set(Options.BATCH_CHUNK_ROWS, 64)
    jconfig.set(JOptions.BATCH_CHUNK_ROWS, 64)
    model = PipelineModel(_idf_lr(d, 3, IDFModel, LogisticRegressionModel))
    jmodel = JPipelineModel(_idf_lr(d, 3, JIDFModel, JLogisticRegressionModel))
    rows = _sparse_rows(N, d, 12, seed=4, cls=SparseVector)
    jrows = _sparse_rows(N, d, 12, seed=4, cls=JSparseVector)
    out = model.transform(DataFrame(["features"], None, [rows]), device="cpu")
    ref = jmodel.transform(JDataFrame(["features"], None, [jrows]))
    (segment,) = model._plan_cache[1].segments
    assert [s.fusion_op for s in segment.specs] == ["sparse_idf", "sparse_logistic"]
    assert chain_eligible(segment.specs) and jax_chain_eligible(segment.specs)
    want_label = "exact" if mode == "exact" else "fast+mega"
    assert {segment.plan_label(key) for key in segment.compiled} == {want_label}
    for r, jr in zip(out.column("tfidf"), ref.column("tfidf")):
        np.testing.assert_array_equal(r.indices, jr.indices)
        np.testing.assert_array_equal(r.values, np.asarray(jr.values))
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))
    assert ulp_diff(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))) \
        <= ULP_ENVELOPE["sparse_idf_logistic"]
    config.set(Options.BATCH_FASTPATH, False)
    per_stage = model.transform(DataFrame(["features"], None, [rows]), device="cpu")
    np.testing.assert_array_equal(out.column("rawPrediction"), per_stage.column("rawPrediction"))


# ---------------------------------------------------------------------------
# the new chains in both plan tiers against the JAX megakernel
# ---------------------------------------------------------------------------


def _kmeans_servables(d, k, jax, seed=13):
    """StandardScaler → Normalizer → KMeans servables of one package."""
    rng = np.random.default_rng(seed)
    mean, std = rng.random(d) * 0.5, rng.random(d) * 0.3 + 0.2
    C = rng.random((k, d))
    C = (C / np.linalg.norm(C, axis=1, keepdims=True)).astype(np.float32)
    if jax:
        sc_cls, norm_cls, km_cls, pipe_cls = (jlib.StandardScalerModelServable, JNormalizer,
                                              jlib.KMeansModelServable, JPipelineServable)
    else:
        sc_cls, norm_cls, km_cls, pipe_cls = (StandardScalerModelServable, Normalizer,
                                              KMeansModelServable, PipelineModelServable)
    sc = sc_cls().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    sc.mean, sc.std = mean, std
    norm = norm_cls().set_input_col("scaled").set_output_col("norm")
    km = km_cls().set_features_col("norm").set_k(k)
    km.centroids, km.weights = C, np.ones(k)
    return pipe_cls([sc, norm, km])


def _mlp_servables(widths, jax, seed=17):
    """Normalizer → MLPClassifier servables of one package."""
    rng = np.random.default_rng(seed)
    params = [((rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
               (rng.normal(size=b) * 0.1).astype(np.float32)) for a, b in zip(widths[:-1], widths[1:])]
    labels = np.arange(widths[-1], dtype=np.float64) * 2.0 + 1.0
    norm = (JNormalizer if jax else Normalizer)().set_input_col("features").set_output_col("norm")
    mlp = (jlib.MLPClassifierModelServable if jax else MLPClassifierModelServable)().set_features_col("norm")
    arrays = {"labels": labels}
    for i, (W, b) in enumerate(params):
        arrays[f"W{i}"], arrays[f"b{i}"] = W, b
    mlp._apply_model_arrays(arrays)
    return (JPipelineServable if jax else PipelineModelServable)([norm, mlp])


def _idf_servable(d, jax, seed=19):
    idf = (JIDFModel if jax else IDFModel)().set_input_col("features").set_output_col("tfidf")
    rng = np.random.default_rng(seed)
    idf.idf, idf.doc_freq, idf.num_docs = np.abs(rng.normal(size=d)) + 0.1, np.ones(d), np.asarray(50.0)
    return (JPipelineServable if jax else PipelineModelServable)([idf])


def _plan_pair(pipe, jpipe, tag, min_score, sparse=None):
    plans = []
    for mode in ("exact", "fast"):
        plans.append((
            CompiledServingPlan.build(pipe, scope=f"tpl-{tag}-{mode}", device="cpu", sparse=sparse,
                                      fusion=FusionTier(mode, min_score=min_score)),
            JPlan.build(jpipe, scope=f"tplj-{tag}-{mode}", sparse=sparse,
                        fusion=JFusionTier(mode, min_score=min_score)),
        ))
    return plans


def test_scale_normalize_kmeans_in_both_tiers_matches_the_jax_megakernel():
    d, k = 100, 10
    pipe, jpipe = _kmeans_servables(d, k, jax=False), _kmeans_servables(d, k, jax=True)
    specs = [s.kernel_spec() for s in pipe.servables]
    assert [s.fusion_op for s in specs] == ["scale", "normalize", "kmeans"]
    assert chain_eligible(specs) and jax_chain_eligible([s.kernel_spec() for s in jpipe.servables])
    X = np.random.default_rng(20).random((N, d))
    X[5] = np.nan
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    per_stage = pipe.transform(df, device="cpu")
    (exact, j_exact), (fast, j_fast) = _plan_pair(pipe, jpipe, "kmeans", min_score=1.0)
    outs = [exact.execute(df), fast.execute(df)]
    refs = [j_exact.execute(jdf), j_fast.execute(jdf)]
    assert chain_kinds(exact) == {N: ("exact", "exact", "exact")}
    assert chain_kinds(fast) == {N: ("megakernel",)}
    assert {s.plan_label(N) for s in j_fast.segments} == {"fast+mega"}
    _assert_frames_bitexact(outs[0], per_stage)
    decided = _decided(per_stage.column("norm"), pipe.servables[2].centroids)
    decided[5] = True  # the NaN row: index 0 everywhere
    for out in outs:
        np.testing.assert_array_equal(out.column("scaled"), per_stage.column("scaled"))
        assert ulp_diff(out.column("norm"), per_stage.column("norm")) <= ENVELOPE
        np.testing.assert_array_equal(out.column("prediction")[decided],
                                      per_stage.column("prediction")[decided])
        for ref, tier in zip(refs, ("exact", "fast+mega")):
            np.testing.assert_array_equal(out.column("scaled"), np.asarray(ref.column("scaled")), tier)
            assert ulp_diff(out.column("norm"), np.asarray(ref.column("norm"))) <= ENVELOPE, tier
            np.testing.assert_array_equal(out.column("prediction")[decided],
                                          np.asarray(ref.column("prediction"))[decided], tier)
    assert outs[1].column("prediction")[5] == 0.0


def test_normalize_mlp_in_both_tiers_matches_the_jax_megakernel():
    widths = [16, 32, 32, 4]
    pipe, jpipe = _mlp_servables(widths, jax=False), _mlp_servables(widths, jax=True)
    specs = [s.kernel_spec() for s in pipe.servables]
    assert [s.fusion_op for s in specs] == ["normalize", "mlp"] and chain_eligible(specs)
    X = np.random.default_rng(21).normal(loc=1.0, scale=2.0, size=(N, 16))
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    per_stage = pipe.transform(df, device="cpu")
    (exact, j_exact), (fast, j_fast) = _plan_pair(pipe, jpipe, "mlp", min_score=1.0)
    outs = [exact.execute(df), fast.execute(df)]
    refs = [j_exact.execute(jdf), j_fast.execute(jdf)]
    assert chain_kinds(fast) == {N: ("megakernel",)}
    assert {s.plan_label(N) for s in j_fast.segments} == {"fast+mega"}
    _assert_frames_bitexact(outs[0], per_stage)
    layers = [(np.asarray(W, np.float64), np.asarray(b, np.float64)) for W, b in pipe.servables[1].layers]
    top = np.sort(_logits(layers, per_stage.column("norm")), axis=1)
    decided = top[:, -1] - top[:, -2] > MLP_MARGIN
    for out in outs:
        for ref in refs + [per_stage]:
            assert ulp_diff(out.column("norm"), np.asarray(ref.column("norm"))) <= ENVELOPE
            assert ulp_diff(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))) \
                <= ULP_ENVELOPE["scale_mlp"]
            np.testing.assert_array_equal(out.column("prediction")[decided],
                                          np.asarray(ref.column("prediction"))[decided])


def test_sparse_idf_alone_in_both_tiers_matches_the_jax_megakernel():
    d = 1000
    pipe, jpipe = _idf_servable(d, jax=False), _idf_servable(d, jax=True)
    rows = _sparse_rows(N, d, 12, seed=22, cls=SparseVector)
    jrows = _sparse_rows(N, d, 12, seed=22, cls=JSparseVector)
    df, jdf = DataFrame(["features"], None, [rows]), JDataFrame(["features"], None, [jrows])
    hints = {"features": d}
    (exact, j_exact), (fast, j_fast) = _plan_pair(pipe, jpipe, "idf", min_score=1.0, sparse=hints)
    (segment,) = fast.segments
    assert [s.fusion_op for s in segment.specs] == ["sparse_idf"] and chain_eligible(segment.specs)
    outs = [exact.execute(df), fast.execute(df)]
    refs = [j_exact.execute(jdf), j_fast.execute(jdf)]
    assert set(chain_kinds(fast).values()) == {("megakernel",)}
    assert {s.plan_label(k) for s in j_fast.segments for k in s.plan_kinds} == {"fast+mega"}
    per_stage = pipe.transform(df, device="cpu")
    for out in outs:
        for ref in refs + [per_stage]:
            for r, jr in zip(out.column("tfidf"), ref.column("tfidf")):
                np.testing.assert_array_equal(r.indices, jr.indices)
                np.testing.assert_array_equal(r.values, np.asarray(jr.values))  # float32 products


def test_cost_model_choice_per_bucket_equals_jax_for_the_new_chains():
    """The three chains at the published widths, over the serving buckets
    and the batch tier's chunk rows: the same hot/cold choice as JAX's."""
    cases = [
        (_kmeans_servables(100, 10, jax=False), _kmeans_servables(100, 10, jax=True), 100, 0, None),
        (_mlp_servables([256, 512, 512, 8], jax=False), _mlp_servables([256, 512, 512, 8], jax=True),
         256, 0, None),
    ]
    tier, jtier = FusionTier("fast"), JFusionTier("fast")
    rows_grid = [1 << i for i in range(13)] + [65_536, 100_000 - 65_536]
    for pipe, jpipe, width, cap, _ in cases:
        specs = [s.kernel_spec() for s in pipe.servables]
        jspecs = [s.kernel_spec() for s in jpipe.servables]
        for rows in rows_grid:
            assert tier.megakernel_hot(specs, rows, width) == jtier.megakernel_hot(jspecs, rows, width), rows
    sparse, jsparse = _idf_servable(1 << 22, jax=False), _idf_servable(1 << 22, jax=True)
    spec = sparse.servables[0].sparse_kernel_spec({"features": 1 << 22})
    jspec = jsparse.servables[0].sparse_kernel_spec({"features": 1 << 22})
    for rows in rows_grid:
        for cap in (1, 2, 4, 8, 16, 32, 64):
            assert tier.megakernel_hot([spec], rows, 0, cap) == jtier.megakernel_hot([jspec], rows, 0, cap)
    # the published KMeans chain scores 208 + 8 + 2008 + 3·400 = 3424 a row: hot from
    # bucket 512 and at 65,536 rows; the MLP chain from 2 rows
    kspecs = [s.kernel_spec() for s in cases[0][0].servables]
    mspecs = [s.kernel_spec() for s in cases[1][0].servables]
    assert chain_score(kspecs, 1, 100) == 3424
    assert [tier.megakernel_hot(kspecs, r, 100) for r in (256, 512, 65_536)] == [False, True, True]
    assert [tier.megakernel_hot(mspecs, r, 256) for r in (1, 2)] == [False, True]


# ---------------------------------------------------------------------------
# save / load both ways, load_servable
# ---------------------------------------------------------------------------


def _fitted_kmeans_pair():
    X = _blobs(300, 8, 3, seed=5)
    model = Pipeline(_kmeans_stages(StandardScaler, Normalizer, KMeans)).fit(
        DataFrame.from_dict({"features": X}), device="cpu")
    jmodel = JPipeline(_kmeans_stages(JStandardScaler, JNormalizer, JKMeans)).fit(
        JDataFrame.from_dict({"features": X}))
    return X, model, jmodel


def test_pipeline_save_load_both_ways(tmp_path, one_device_mesh):
    est = Pipeline(_kmeans_stages(StandardScaler, Normalizer, KMeans, k=4))
    jest = JPipeline(_kmeans_stages(JStandardScaler, JNormalizer, JKMeans, k=4))
    est.save(str(tmp_path / "port"))
    jest.save(str(tmp_path / "jax"))
    with pytest.raises(IOError):
        est.save(str(tmp_path / "port"))
    for path in ("port", "jax"):
        loaded = Pipeline.load(str(tmp_path / path))
        assert [type(s).__name__ for s in loaded.stages] == ["StandardScaler", "Normalizer", "KMeans"]
        assert [s.param_map_to_json() for s in loaded.stages] == [s.param_map_to_json() for s in est.stages]
    # the port writes the JAX twin's class names: its directories read as
    # the JAX package writes them, and the JAX package loads them
    meta = jrw.load_metadata(str(tmp_path / "port"))
    jmeta = jrw.load_metadata(str(tmp_path / "jax"))
    assert meta["numStages"] == jmeta["numStages"] == 3
    assert meta["className"] == jmeta["className"] == "flink_ml_tpu.builder.pipeline.Pipeline"
    for i in range(3):
        sub = f"stages/{i:08d}"
        assert jrw.load_metadata(str(tmp_path / "port" / sub))["paramMap"] == \
            jrw.load_metadata(str(tmp_path / "jax" / sub))["paramMap"]
    jloaded = JPipeline.load(str(tmp_path / "port"))
    assert [type(s) for s in jloaded.stages] == [JStandardScaler, JNormalizer, JKMeans]
    assert [s.param_map_to_json() for s in jloaded.stages] == [s.param_map_to_json() for s in jest.stages]
    # a port-saved PipelineModel (StandardScaler -> LogisticRegression) loads through
    # the JAX PipelineModel.load, and transforms as the port's does
    rng = np.random.default_rng(31)
    X = rng.normal(size=(N, 6))
    scaler = StandardScalerModel().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    scaler.mean, scaler.std = rng.normal(size=6), np.abs(rng.normal(size=6)) + 0.5
    lr = LogisticRegressionModel().set_features_col("scaled")
    lr.coefficient = rng.normal(size=6)
    model = PipelineModel([scaler, lr])
    model.save(str(tmp_path / "port-model"))
    jmodel = JPipelineModel.load(str(tmp_path / "port-model"))
    assert [type(s) for s in jmodel.stages] == [JStandardScalerModel, JLogisticRegressionModel]
    assert type(jrw.load_stage(str(tmp_path / "port-model"))) is JPipelineModel
    want = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    got = jmodel.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_allclose(np.asarray(got.column("scaled")), want.column("scaled"), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.column("rawPrediction")), want.column("rawPrediction"),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.column("prediction")), want.column("prediction"))


def test_pipeline_model_save_load_both_ways(tmp_path, one_device_mesh):
    X, model, jmodel = _fitted_kmeans_pair()
    model.save(str(tmp_path / "port"))
    jmodel.save(str(tmp_path / "jax"))
    df = DataFrame.from_dict({"features": X})
    want = model.transform(df, device="cpu")
    for path in ("port", "jax"):
        loaded = PipelineModel.load(str(tmp_path / path))
        assert [type(s).__name__ for s in loaded.stages] == ["StandardScalerModel", "Normalizer", "KMeansModel"]
        got = loaded.transform(df, device="cpu")
        np.testing.assert_array_equal(got.column("prediction"), want.column("prediction"))
        np.testing.assert_allclose(got.column("norm"), want.column("norm"), rtol=0, atol=1e-6)
    # the reverse direction: metadata and model data as the JAX package reads them
    meta = jrw.load_metadata(str(tmp_path / "port"))
    assert meta["numStages"] == 3
    km_dir = str(tmp_path / "port" / "stages" / f"{2:08d}")
    np.testing.assert_array_equal(jrw.load_model_arrays(km_dir)["centroids"], model.stages[2].centroids)
    sc_dir = str(tmp_path / "port" / "stages" / f"{0:08d}")
    np.testing.assert_array_equal(jrw.load_model_arrays(sc_dir)["mean"], model.stages[0].mean)
    jserv = JPipelineServable([jlib.StandardScalerModelServable.load_servable(sc_dir), JNormalizer.load(
        str(tmp_path / "jax" / "stages" / f"{1:08d}")), jlib.KMeansModelServable.load_servable(km_dir)])
    ref = jserv.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_array_equal(np.asarray(ref.column("prediction")), want.column("prediction"))


def test_load_servable_of_a_jax_saved_pipeline_model_serves_in_the_port(tmp_path, one_device_mesh):
    X, _model, jmodel = _fitted_kmeans_pair()
    jmodel.save(str(tmp_path / "jax"))
    servable = PipelineModel.load_servable(str(tmp_path / "jax"))
    assert isinstance(servable, PipelineModelServable)
    assert [type(s).__name__ for s in servable.servables] == \
        ["StandardScalerModelServable", "Normalizer", "KMeansModelServable"]
    specs = [s.kernel_spec() for s in servable.servables]
    assert [s.fusion_op for s in specs] == ["scale", "normalize", "kmeans"] and chain_eligible(specs)
    requests = [X[:7], X[7:70], X[70:71]]
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    cfg = ServingConfig(max_batch_size=64, queue_capacity_rows=512, fusion_mode="fast")
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)
    template = DataFrame.from_dict({"features": X[:1]})
    with InferenceServer(servable, name="tpl-serve", serving_config=cfg, warmup_template=template,
                         device="cpu") as server:
        outs = [server.predict(DataFrame.from_dict({"features": r})).dataframe for r in requests]
    got = np.concatenate([o.column("prediction") for o in outs])
    np.testing.assert_array_equal(got, np.asarray(ref.column("prediction"))[:71])
    norm = np.concatenate([o.column("norm") for o in outs])
    assert ulp_diff(norm, np.asarray(ref.column("norm"))[:71]) <= ENVELOPE
    # a port-saved PipelineModel loads the same way
    PipelineModel.load(str(tmp_path / "jax")).save(str(tmp_path / "port"))
    again = PipelineModel.load_servable(str(tmp_path / "port"))
    assert [type(s).__name__ for s in again.servables] == [type(s).__name__ for s in servable.servables]
    with open(os.path.join(tmp_path, "port", "metadata")) as f:
        assert json.load(f)["numStages"] == 3


def test_class_table_rows_for_the_pipeline_and_its_estimators():
    from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegression
    from flink_ml_tpu_torch.models.feature.idf import IDF
    from flink_ml_tpu_torch.utils import read_write as rw

    pipeline_model = "flink_ml_tpu.builder.pipeline.PipelineModel"
    assert rw.resolve_class(pipeline_model) is PipelineModelServable
    assert rw.resolve_class(pipeline_model, stage=True) is PipelineModel
    assert rw.resolve_class("flink_ml_tpu.builder.pipeline.Pipeline", stage=True) is Pipeline
    with pytest.raises(ValueError, match="no port class"):
        rw.resolve_class("flink_ml_tpu.builder.pipeline.Pipeline")  # an Estimator serves nothing
    for jname, cls in (("feature.standard_scaler.StandardScaler", StandardScaler),
                       ("clustering.kmeans.KMeans", KMeans),
                       ("classification.mlp_classifier.MLPClassifier", MLPClassifier),
                       ("classification.logistic_regression.LogisticRegression", LogisticRegression),
                       ("feature.idf.IDF", IDF)):
        assert rw.resolve_class(f"flink_ml_tpu.models.{jname}", stage=True) is cls
    assert rw.resolve_class(rw.stage_class_name(PipelineModel)) is PipelineModel
