"""The port's kernel modules against the JAX package on the CPU: the
``ops/kernels`` functions, the megakernel chain's plain version against the
JAX serving plan in the exact tier and in the fast tier with the Pallas
megakernel (run in interpret mode, as the JAX package's own tests run it),
the chains the port has kernels for, and the wrapper's device rule. Tests of
the CUDA kernel itself are in ``test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.servable.megakernels import MEGAKERNEL_OPS, chain_eligible as jax_chain_eligible
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan

import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.servable import (
    LogisticRegressionModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier, ulp_diff
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.megakernels import (
    KMEANS_MAX_DIM,
    KMEANS_MAX_K,
    MEGAKERNEL_CHAINS,
    MLP_MAX_CLASSES,
    MLP_MAX_HEADS,
    MLP_MAX_LAYERS,
    MLP_MAX_NORM_FLOATS,
    MLP_MAX_WIDTH,
    ROWLOCAL_MAX_DIM,
    ROWLOCAL_MAX_NORM_FLOATS,
    ROWLOCAL_MAX_OPS,
    ROWLOCAL_OPS,
    SCALE_LOGISTIC,
    SPARSE_OPS,
    TABLE_OPS,
    build_megakernel_fn,
    chain_eligible,
    scale_logistic,
    scale_logistic_plain,
)
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

WIDTHS = (8, 16, 100, 256)
N = 203  # odd: the JAX megakernel's single-tile tail path
ENVELOPE = ULP_ENVELOPE["scale_logistic"]
FLAGS = [(True, True), (True, False), (False, True), (False, False)]


def _model(d, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=d)
    std = np.abs(rng.normal(size=d)) + 0.5
    std[d // 2] = 0.0  # the zero-std guard
    coef = rng.normal(size=d)
    return mean, std, coef


def _inv_std(std):
    s = np.asarray(std, np.float32)
    return np.where(s == 0.0, 0.0, 1.0 / np.where(s == 0.0, 1.0, s))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


# ---------------------------------------------------------------------------
# ops/kernels functions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_mean,with_std", FLAGS)
def test_scale_fn_matches_jax_within_one_ulp(width, with_mean, with_std):
    mean, std, _ = _model(width, seed=width)
    X = np.random.default_rng(1).normal(size=(N, width)).astype(np.float32)
    inv = _inv_std(std)
    port = tk.scale_fn(_t(X), _t(mean), _t(inv), with_mean=with_mean, with_std=with_std)
    ref = jk.scale_fn(
        jnp.asarray(X), jnp.asarray(mean, jnp.float32), jnp.asarray(inv),
        with_mean=with_mean, with_std=with_std,
    )
    assert ulp_diff(port.numpy(), np.asarray(ref)) <= 1


@pytest.mark.parametrize("width", WIDTHS)
def test_dot_and_logistic_head_match_jax_within_envelope(width):
    _, _, coef = _model(width, seed=width)
    X = np.random.default_rng(2).normal(size=(N, width)).astype(np.float32)
    dots = tk.dot_fn(_t(X), _t(coef))
    pred, raw = tk.logistic_from_dots_fn(dots)
    ref_dots = jk.dot_kernel()(X, jnp.asarray(coef, jnp.float32))
    ref_pred, ref_raw = jk.logistic_from_dots_fn(ref_dots)
    margin = np.asarray(ref_dots)
    assert ulp_diff(raw.numpy(), np.asarray(ref_raw)) <= ENVELOPE
    decided = np.abs(margin) > 1e-4
    np.testing.assert_array_equal(pred.numpy()[decided], np.asarray(ref_pred)[decided])
    assert pred.dtype == torch.float32 and raw.shape == (N, 2)


# ---------------------------------------------------------------------------
# the megakernel chain's plain version against the JAX serving plan
# ---------------------------------------------------------------------------


def _servables(width, with_mean, with_std, seed=3):
    mean, std, coef = _model(width, seed)

    def build(sc_cls, lr_cls, pipe_cls):
        sc = sc_cls().set_input_col("features").set_output_col("scaled")
        sc.set_with_mean(with_mean)
        sc.set_with_std(with_std)
        sc.mean, sc.std = mean, std
        lr = lr_cls().set_features_col("scaled")
        lr.coefficient = coef
        return pipe_cls([sc, lr])

    return (
        build(StandardScalerModelServable, LogisticRegressionModelServable, PipelineModelServable),
        build(jlib.StandardScalerModelServable, jlib.LogisticRegressionModelServable, JPipeline),
    )


def _plain_chain(port_pipe, X):
    sc, lr = port_pipe.servables
    scaled, pred, raw = scale_logistic(
        _t(X), _t(sc.mean), _t(sc._inv_std()), _t(lr.coefficient),
        with_mean=sc.get_with_mean(), with_std=sc.get_with_std(), write_scaled=True,
    )
    return {"scaled": scaled.numpy(), "prediction": pred.numpy(), "rawPrediction": raw.numpy()}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True)])
def test_plain_megakernel_chain_matches_jax_exact_and_megakernel_tiers(width, with_mean, with_std):
    port_pipe, jax_pipe = _servables(width, with_mean, with_std)
    X = np.random.default_rng(7).normal(size=(N, width))
    plain = _plain_chain(port_pipe, X)
    jdf = JDataFrame.from_dict({"features": X})
    exact = JPlan.build(jax_pipe, scope=f"tk-e{width}").execute(jdf)
    mega_plan = JPlan.build(
        jax_pipe, scope=f"tk-m{width}", fusion=JFusionTier("fast", min_score=1.0)
    )
    mega = mega_plan.execute(jdf)
    assert "fast+mega" in {s.plan_label(N) for s in mega_plan.segments}
    for ref, tier in ((exact, "exact"), (mega, "fast+mega")):
        for name in ("scaled", "prediction", "rawPrediction"):
            u = ulp_diff(plain[name], np.asarray(ref.column(name)))
            assert u <= ENVELOPE, f"{tier} d={width}: {name} moved {u} ulps"
        np.testing.assert_array_equal(plain["prediction"], np.asarray(ref.column("prediction")))
    # scaled is elementwise: no accumulation order, so it is bit-identical
    np.testing.assert_array_equal(plain["scaled"], np.asarray(exact.column("scaled"), np.float32))


@pytest.mark.parametrize("width", (16, 100))
def test_port_plan_tiers_on_cpu(width):
    """Exact tier = per-stage transform bit for bit; the fast tier's
    megakernel program on CPU tensors = the plain chain bit for bit."""
    port_pipe, _ = _servables(width, True, True)
    X = np.random.default_rng(11).normal(size=(N, width))
    df = DataFrame.from_dict({"features": X})
    per_stage = port_pipe.transform(df, device="cpu")
    exact = CompiledServingPlan.build(port_pipe, scope=f"tp-e{width}", device="cpu").execute(df)
    mega_plan = CompiledServingPlan.build(
        port_pipe, scope=f"tp-m{width}", device="cpu", fusion=FusionTier("fast", min_score=1.0)
    )
    mega = mega_plan.execute(df)
    assert [seg.plan_kinds for seg in mega_plan.segments] == [{N: ("megakernel",)}]
    plain = _plain_chain(port_pipe, X)
    for name in ("scaled", "prediction", "rawPrediction"):
        np.testing.assert_array_equal(exact.column(name), per_stage.column(name))
        np.testing.assert_array_equal(mega.column(name), plain[name].astype(np.float64))
        assert mega.column(name).dtype == np.float64


# ---------------------------------------------------------------------------
# which chains have a kernel
# ---------------------------------------------------------------------------


def _spec(op, inputs=("x",), outputs=("y",), arrays=None, params=None):
    return KernelSpec(
        input_cols=inputs,
        outputs=[(o, None) for o in outputs],
        model_arrays=arrays if arrays is not None else {"w": np.ones(4, np.float32)},
        kernel_fn=lambda m, c: {},
        fusion_op=op,
        fusion_params=params,
    )


def _scale(out="scaled"):
    return _spec("scale", outputs=(out,),
                 arrays={"mean": np.zeros(4, np.float32), "inv_std": np.ones(4, np.float32)},
                 params={"with_mean": True, "with_std": True})


def _logistic(inp="scaled", width=4):
    return _spec("logistic", inputs=(inp,), outputs=("prediction", "rawPrediction"),
                 arrays={"coefficient": np.ones(width, np.float32)})


def _sparse_idf(out="tfidf", width=4, inp="features"):
    return KernelSpec(
        input_cols=(inp,), outputs=[(out, None)],
        model_arrays={"idf": np.ones(width, np.float32)}, kernel_fn=lambda m, c: {},
        input_kinds={inp: "sparse"}, sparse_outputs={out: width},
        sparse_input_dims={inp: width}, elementwise=True, fusion_op="sparse_idf",
    )


def _sparse_logistic(inp="tfidf", width=4, kind="sparse"):
    return KernelSpec(
        input_cols=(inp,), outputs=[("prediction", None), ("rawPrediction", None)],
        model_arrays={"coefficient": np.ones(width, np.float32)}, kernel_fn=lambda m, c: {},
        input_kinds={inp: kind}, fusion_op="sparse_logistic",
    )


#: The four classes of chains that only the table kernels' sparse ops,
#: typed slots and MLP phases admit — an MLP head followed by further ops,
#: sparse and dense ops in one run, sparse runs past the three with kernels
#: of their own, an op reading a kmeans index — one well-formed chain of
#: each, all of which the JAX package lowers as one Pallas megakernel too.
NOT_YET_PORTED = {
    "mlp_not_last": lambda: [_mlp(inp="x"), _rowlocal("scale", "x", "z")],
    "sparse_with_dense": lambda: [_sparse_idf(), _sparse_logistic(), _rowlocal("scale", "x", "z")],
    "other_sparse_run": lambda: [_sparse_idf(out="t1"), _sparse_idf(out="t2", inp="t1")],
    "reads_kmeans_index": lambda: [_kmeans(inp="x"), _rowlocal("binarize", "prediction", "bin")],
}


def _rowlocal(op, inp="x", out="y", width=4, **params):
    """A row-local spec of ``op``'s form reading ``inp`` into ``out``."""
    ones = np.ones(width, np.float32)
    if op == "scale":
        return _spec(op, (inp,), (out,), {"mean": ones, "inv_std": ones},
                     {"with_mean": True, "with_std": True})
    if op == "normalize":
        return _spec(op, (inp,), (out,), {}, {"p": params.get("p", 2.0)})
    if op in ("elementwise_product", "idf"):
        return _spec(op, (inp,), (out,), {"scaling" if op == "elementwise_product" else "idf": ones})
    if op == "binarize":
        return _spec(op, (inp,), (out,), {}, {"thresholds": (0.05,)})
    assert op == "impute"
    return _spec(op, (inp,), (out,), {"surrogates": np.ones(1, np.float32)},
                 {"missing_is_nan": True, "missing_value": 0.0})


def _feature6_specs(width=4, head=False):
    cols = ["x", "scaled", "norm", "weighted", "tfidf", "rescaled", "bin"]
    ops = ["scale", "normalize", "elementwise_product", "idf", "scale", "binarize"]
    specs = [_rowlocal(op, cols[i], cols[i + 1], width) for i, op in enumerate(ops)]
    return specs + ([_logistic("bin", width)] if head else [])


def _mlp(widths=(4, 8, 3), inp="scaled", drop=None):
    """An MLP head of ``widths`` reading ``inp``; ``drop`` removes a model array."""
    arrays = {"labels": np.arange(widths[-1], dtype=np.float32)}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        arrays[f"W{i}"] = np.ones((a, b), np.float32)
        arrays[f"b{i}"] = np.zeros(b, np.float32)
    arrays.pop(drop, None)
    return _spec("mlp", inputs=(inp,), outputs=("prediction", "rawPrediction"), arrays=arrays)


def _kmeans(k=3, d=4, inp="scaled", measure="euclidean"):
    """A KMeans head of ``k`` centroids of width ``d`` reading ``inp``."""
    return _spec("kmeans", inputs=(inp,), outputs=("prediction",),
                 arrays={"centroids": np.ones((k, d), np.float32)},
                 params={"distance_measure": measure})


def test_port_admits_exactly_the_chains_it_has_kernels_for():
    assert MEGAKERNEL_CHAINS == {
        ("scale", "logistic"), ("logistic",), ("sparse_idf", "sparse_logistic"), ("sparse_logistic",),
        ("scale", "kmeans"), ("kmeans",),
    }  # ("scale", "mlp") and ("mlp",) run on the MLP kernel's table prologue
    assert chain_eligible([_scale(), _logistic()])
    assert chain_eligible([_logistic(inp="features")])
    assert chain_eligible([_sparse_idf(), _sparse_logistic()])
    assert chain_eligible([_sparse_logistic(inp="features")])
    assert chain_eligible([_scale(), _mlp()])
    assert chain_eligible([_mlp(inp="features")])
    assert chain_eligible([_mlp((4, 512, 512, 8), inp="x")])  # the published network's shape
    limits = (4,) + (MLP_MAX_WIDTH,) * (MLP_MAX_LAYERS - 1) + (MLP_MAX_CLASSES,)
    assert chain_eligible([_scale(), _mlp(limits)])
    for measure in ("euclidean", "manhattan", "cosine"):
        assert chain_eligible([_scale(), _kmeans(measure=measure)])
        assert chain_eligible([_kmeans(inp="features", measure=measure)])
    assert chain_eligible([_kmeans(10, 100, inp="x")])  # the published model's shape
    assert chain_eligible([_kmeans(KMEANS_MAX_K, KMEANS_MAX_DIM, inp="x")])
    for specs in ([_sparse_idf(), _sparse_logistic()], [_sparse_logistic()],
                  [_scale(), _mlp()], [_mlp()], [_scale(), _kmeans()], [_kmeans()]):
        assert jax_chain_eligible(specs)  # the JAX package lowers these chains too
    assert set(NOT_YET_PORTED) == {"mlp_not_last", "sparse_with_dense", "other_sparse_run",
                                   "reads_kmeans_index"}
    for name, make in NOT_YET_PORTED.items():
        specs = make()
        assert _residue(specs) == name, name
        assert all(s.fusion_op in MEGAKERNEL_OPS for s in specs), name
        assert jax_chain_eligible(specs), name  # the JAX package lowers it
        assert chain_eligible(specs), name  # and so does the port: the table kernels
        build_megakernel_fn(specs)
    # a row-local prefix before kmeans or mlp, and the sparse IDF alone: ported
    for specs in ([_rowlocal("normalize"), _kmeans(inp="y")],
                  [_rowlocal("scale", "x", "s"), _rowlocal("normalize", "s", "n"), _kmeans(inp="n")],
                  [_rowlocal("normalize"), _mlp(inp="y")],
                  [_rowlocal("elementwise_product", "x", "p"), _rowlocal("scale", "p", "s"),
                   _mlp(inp="s")],
                  [_sparse_idf()]):
        assert chain_eligible(specs), [s.fusion_op for s in specs]
        assert jax_chain_eligible(specs)
        build_megakernel_fn(specs)
    wrong_out = _sparse_idf()
    wrong_out.sparse_outputs = {}  # IDF alone must keep its output sparse
    assert not chain_eligible([wrong_out])
    # the table kernels: any chain of TABLE_OPS (the heads anywhere), which are every op the
    # JAX package lowers
    assert TABLE_OPS == ROWLOCAL_OPS | SPARSE_OPS | {"logistic", "kmeans", "mlp"} == MEGAKERNEL_OPS
    for specs in (_feature6_specs(), _feature6_specs(head=True), [_rowlocal("scale")],
                  [_rowlocal("normalize")], [_rowlocal("impute")],
                  _feature6_specs(ROWLOCAL_MAX_DIM, head=True)):
        assert chain_eligible(specs), [s.fusion_op for s in specs]
        assert jax_chain_eligible(specs)
        build_megakernel_fn(specs)
    assert not chain_eligible(_feature6_specs(ROWLOCAL_MAX_DIM + 1))  # a model vector too wide
    assert not chain_eligible(_feature6_specs(ROWLOCAL_MAX_DIM + 1, head=True))
    assert not chain_eligible([_rowlocal("normalize", p=0.5)])  # p < 1
    assert not chain_eligible([_spec("scale")])  # no mean / inv_std, no flags
    assert not chain_eligible([_spec("normalize")])  # no p
    assert chain_eligible([_rowlocal("binarize"), _logistic("y", width=5), _rowlocal("idf")])  # a head need not be last
    assert not chain_eligible([_rowlocal("binarize", width=4)] * (ROWLOCAL_MAX_OPS + 1))  # table too long
    # the centroids a table's kmeans ops hold in all: their norms share the block's shared memory,
    # with the activations in the MLP kernel (the row-local kernel's table is full first)
    assert ROWLOCAL_MAX_OPS * KMEANS_MAX_K <= ROWLOCAL_MAX_NORM_FLOATS
    assert chain_eligible([_kmeans(KMEANS_MAX_K, inp="x")] * ROWLOCAL_MAX_OPS)
    mlp_k = MLP_MAX_NORM_FLOATS // KMEANS_MAX_K
    assert chain_eligible([_kmeans(KMEANS_MAX_K, inp="x")] * mlp_k + [_mlp(inp="x")])
    assert not chain_eligible([_kmeans(KMEANS_MAX_K, inp="x")] * (mlp_k + 1) + [_mlp(inp="x")])
    sparse_in = _rowlocal("binarize")
    sparse_in.input_kinds["x"] = "sparse"
    assert not chain_eligible([sparse_in])  # a dense op reads dense and scalar columns only
    assert not chain_eligible([_mlp(inp="x")] * (MLP_MAX_HEADS + 1))  # MLP heads past the kernel's
    assert chain_eligible([_mlp(inp="x")] * MLP_MAX_HEADS)
    # an op that needs [rows, width] reading a head's [rows] prediction or a kmeans index
    assert not chain_eligible([_kmeans(inp="x"), _rowlocal("scale", "prediction", "z", width=1)])
    assert not chain_eligible([_logistic(inp="x"), _rowlocal("normalize", "prediction", "z")])
    # dataflow and shapes the kernels cannot take
    assert chain_eligible([_scale(out="other"), _logistic()])  # the head reads an input: the table
    assert not chain_eligible([_scale(), _logistic(width=5)])  # widths the model arrays fix disagree
    assert chain_eligible([_logistic(inp="scaled")] * 2)  # two heads: the table
    assert not chain_eligible([])
    assert chain_eligible([_sparse_idf(out="other"), _sparse_logistic()])  # idf feeds another column: the table
    assert chain_eligible([_sparse_idf(width=5), _sparse_logistic()])  # idf of another width: the table, ids clamped
    assert not chain_eligible([_sparse_idf(), _sparse_logistic(kind="vector")])  # a sparse head on a dense column
    assert not chain_eligible([_sparse_logistic(inp="features", kind="vector")])
    assert not chain_eligible([_spec("sparse_idf"), _spec("sparse_logistic")])  # no coefficient/idf
    # MLP networks the kernel cannot hold, or heads not of the MLP's form
    assert not chain_eligible([_scale(), _mlp((5, 8, 3))])  # the scaler's width is not W0's
    assert chain_eligible([_scale(out="other"), _mlp()])  # the scaler feeds another column: the prologue
    assert not chain_eligible([_spec("scale"), _spec("mlp")])  # no network
    assert not chain_eligible([_mlp((4,) + (8,) * MLP_MAX_LAYERS + (3,))])  # one layer too many
    assert not chain_eligible([_mlp((4, MLP_MAX_WIDTH + 1, 3))])  # a hidden layer too wide
    assert not chain_eligible([_mlp((MLP_MAX_WIDTH + 1, 8, 3))])  # an input too wide
    assert not chain_eligible([_mlp((4, 8, MLP_MAX_CLASSES + 1))])  # too many classes
    assert not chain_eligible([_mlp(drop="labels")])
    assert not chain_eligible([_mlp(drop="b1")])
    gap = _mlp((4, 8, 3))
    gap.model_arrays["W1"] = np.ones((7, 3), np.float32)  # widths that do not chain up
    assert not chain_eligible([gap])
    bias = _mlp((4, 8, 3))
    bias.model_arrays["b0"] = np.zeros(7, np.float32)  # a bias of another width
    assert not chain_eligible([bias])
    labels = _mlp((4, 8, 3))
    labels.model_arrays["labels"] = np.zeros(4, np.float32)  # a label per class, no more
    assert not chain_eligible([labels])
    extra = _mlp((4, 8, 3))
    extra.model_arrays["W5"] = np.ones((3, 3), np.float32)  # a layer off the chain
    assert not chain_eligible([extra])
    # KMeans models the kernel cannot hold, or heads not of the KMeans form
    assert not chain_eligible([_scale(), _kmeans(d=5)])  # the scaler's width is not the centroids'
    assert chain_eligible([_scale(out="other"), _kmeans()])  # the scaler feeds another column: the table
    assert not chain_eligible([_kmeans(KMEANS_MAX_K + 1, 4)])  # too many centroids
    assert not chain_eligible([_kmeans(3, KMEANS_MAX_DIM + 1)])  # too wide
    assert not chain_eligible([_kmeans(measure="chebyshev")])  # a measure the kernel lacks
    assert not chain_eligible([_spec("kmeans")])  # no centroids, no measure
    flat = _kmeans()
    flat.model_arrays["centroids"] = np.ones(4, np.float32)  # centroids must be [k, d]
    assert not chain_eligible([flat])
    two = _spec("kmeans", outputs=("prediction", "distance"),
                arrays={"centroids": np.ones((3, 4), np.float32)}, params={"distance_measure": "cosine"})
    assert not chain_eligible([two])  # one output: the index
    with pytest.raises(ValueError, match="no megakernel"):
        build_megakernel_fn([_spec("kmeans")])


# ---------------------------------------------------------------------------
# the wrapper: plain version for CPU tensors, kernel or raise otherwise
# ---------------------------------------------------------------------------


def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_counting():
    mean, std, coef = _model(100, seed=5)
    X = np.random.default_rng(3).normal(size=(64, 100))
    before = SCALE_LOGISTIC.launches
    for with_mean, with_std in FLAGS:
        args = (_t(X), _t(mean), _t(_inv_std(std)), _t(coef))
        scaled, pred, raw = scale_logistic(*args, with_mean=with_mean, with_std=with_std, write_scaled=True)
        p_scaled, p_pred, p_raw = scale_logistic_plain(*args, with_mean=with_mean, with_std=with_std)
        assert torch.equal(scaled, p_scaled) and torch.equal(pred, p_pred) and torch.equal(raw, p_raw)
    none, _, _ = scale_logistic(_t(X), None, None, _t(coef), with_mean=False, with_std=False,
                                write_scaled=False)
    assert none is None
    assert SCALE_LOGISTIC.launches == before  # the count is of kernel launches only


def test_wrapper_raises_for_tensors_it_has_no_path_for():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        scale_logistic(x, None, None, torch.empty(8, device="meta"),
                       with_mean=False, with_std=False, write_scaled=False)


def test_cuda_launch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = SCALE_LOGISTIC.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SCALE_LOGISTIC.launch(*([None] * 7 + [1, 8, 0, 0, 0, None]))
    assert SCALE_LOGISTIC.launches == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledServingPlan.build(_servables(8, True, True)[0], device="cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if (native.Path("/usr/local/cuda/bin/nvcc")).is_file():
        pytest.skip("nvcc is installed under /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build(SCALE_LOGISTIC.source)
    assert SCALE_LOGISTIC.source_path == "flink_ml_tpu_torch/csrc/megakernel_scale_logistic.cu"
    assert (native.CSRC_DIR / SCALE_LOGISTIC.source).is_file()
    assert SCALE_LOGISTIC in native.KERNELS


# ---------------------------------------------------------------------------
# the port's chain_eligible against the JAX one, on every chain the planner
# forms from the ported stages
# ---------------------------------------------------------------------------

import itertools  # noqa: E402

from flink_ml_tpu.models.feature.binarizer import Binarizer as JBinarizer  # noqa: E402
from flink_ml_tpu.models.feature.elementwise_product import ElementwiseProduct as JElementwiseProduct  # noqa: E402
from flink_ml_tpu.models.feature.idf import IDFModel as JIDFModel  # noqa: E402
from flink_ml_tpu.models.feature.imputer import ImputerModel as JImputerModel  # noqa: E402
from flink_ml_tpu.models.feature.normalizer import Normalizer as JNormalizer  # noqa: E402
from flink_ml_tpu.servable.planner import FusedSegment as JFusedSegment  # noqa: E402
from flink_ml_tpu.servable.planner import build_segments as jax_build_segments  # noqa: E402

from flink_ml_tpu_torch.models.feature.binarizer import Binarizer  # noqa: E402
from flink_ml_tpu_torch.models.feature.elementwise_product import ElementwiseProduct  # noqa: E402
from flink_ml_tpu_torch.models.feature.idf import IDFModel  # noqa: E402
from flink_ml_tpu_torch.models.feature.imputer import ImputerModel  # noqa: E402
from flink_ml_tpu_torch.models.feature.normalizer import Normalizer  # noqa: E402
from flink_ml_tpu_torch.servable import KMeansModelServable, MLPClassifierModelServable  # noqa: E402
from flink_ml_tpu_torch.servable.planner import FusedSegment, build_segments  # noqa: E402

_POOL_D = 4
_POOL = ("scale", "normalize", "product", "idf", "binarize", "binarize_pred", "impute", "logistic",
         "kmeans", "mlp", "sparse_idf", "sparse_logistic")


def _pool_stage(name, jax):
    """One ported stage of each spec form, in the port or the JAX package,
    each reading and writing the column ``x`` (scalar ``s``, sparse ``f``)
    so that any sequence of them is a chain."""
    d, rng = _POOL_D, np.random.default_rng(_POOL.index(name))
    lib = jlib if jax else __import__("flink_ml_tpu_torch.servable", fromlist=["x"])
    if name == "scale":
        s = lib.StandardScalerModelServable().set_input_col("x").set_output_col("x").set_with_mean(True)
        s.mean, s.std = rng.normal(size=d), np.abs(rng.normal(size=d)) + 0.5
        return s
    if name == "normalize":
        return (JNormalizer if jax else Normalizer)().set_input_col("x").set_output_col("x")
    if name == "product":
        return (JElementwiseProduct if jax else ElementwiseProduct)().set_scaling_vec(
            rng.normal(size=d)).set_input_col("x").set_output_col("x")
    if name in ("idf", "sparse_idf"):
        col = "x" if name == "idf" else "f"
        s = (JIDFModel if jax else IDFModel)().set_input_col(col).set_output_col(col)
        s.idf, s.doc_freq, s.num_docs = np.abs(rng.normal(size=d)), np.ones(d), np.asarray(9.0)
        return s
    if name in ("binarize", "binarize_pred"):
        col, out = ("x", "x") if name == "binarize" else ("prediction", "pb")
        return (JBinarizer if jax else Binarizer)().set_input_cols(col).set_output_cols(out).set_thresholds(0.1)
    if name == "impute":
        s = (JImputerModel if jax else ImputerModel)().set_input_cols("s").set_output_cols("s")
        s.surrogates = rng.normal(size=1)
        return s
    if name in ("logistic", "sparse_logistic"):
        s = lib.LogisticRegressionModelServable().set_features_col("x" if name == "logistic" else "f")
        s.coefficient = rng.normal(size=d)
        return s
    if name == "kmeans":
        s = (jlib.KMeansModelServable if jax else KMeansModelServable)().set_features_col("x").set_k(3)
        s.centroids, s.weights = rng.normal(size=(3, d)).astype(np.float32), np.ones(3)
        return s
    assert name == "mlp"
    s = (jlib.MLPClassifierModelServable if jax else MLPClassifierModelServable)().set_features_col("x")
    s._apply_model_arrays({"W0": rng.normal(size=(d, 8)).astype(np.float32), "b0": np.zeros(8, np.float32),
                           "W1": rng.normal(size=(8, 3)).astype(np.float32), "b1": np.zeros(3, np.float32),
                           "labels": np.arange(3.0)})
    return s


def _residue(specs):
    """The class of ``NOT_YET_PORTED`` a run of specs falls in, or None."""
    ops = tuple(s.fusion_op for s in specs)
    sparse = {"sparse_idf", "sparse_logistic"}
    if "mlp" in ops[:-1]:
        return "mlp_not_last"
    if set(ops) & sparse and set(ops) - sparse:
        return "sparse_with_dense"
    if set(ops) <= sparse and ops not in (("sparse_idf",), ("sparse_logistic",),
                                          ("sparse_idf", "sparse_logistic")):
        return "other_sparse_run"
    index_cols = set()
    for s in specs:
        if index_cols & set(s.input_cols):
            return "reads_kmeans_index"
        index_cols -= set(s.output_names)
        if s.fusion_op == "kmeans":
            index_cols |= set(s.output_names)
    return None


def test_port_chain_eligible_equals_jax_on_every_chain_the_planner_forms():
    """Every sequence of one to three ported stages, planned in the fast tier
    by both packages with ``f`` known sparse: the same runs, and each run
    admitted and built by the port exactly as the JAX package admits it —
    the four classes of ``NOT_YET_PORTED`` among them, each counted."""
    fast, jfast, hints = FusionTier("fast"), JFusionTier("fast"), {"f": _POOL_D}
    port = {name: _pool_stage(name, jax=False) for name in _POOL}
    jax = {name: _pool_stage(name, jax=True) for name in _POOL}
    seen = {"runs": 0, "admitted": 0, "classes": {k: 0 for k in NOT_YET_PORTED}}
    for n in (1, 2, 3):
        for names in itertools.product(_POOL, repeat=n):
            segs = [s for s in build_segments([port[k] for k in names], torch.device("cpu"), fast, hints)
                    if isinstance(s, FusedSegment)]
            jsegs = [s for s in jax_build_segments([jax[k] for k in names], None, jfast, hints)
                     if isinstance(s, JFusedSegment)]
            runs = [p.specs for s in segs for p in s.programs]
            jruns = [p.specs for s in jsegs for p in s.programs]
            assert [[s.fusion_op for s in r] for r in runs] == [[s.fusion_op for s in r] for r in jruns], names
            for specs, jspecs in zip(runs, jruns):
                seen["runs"] += 1
                assert chain_eligible(specs) == jax_chain_eligible(jspecs), names
                if chain_eligible(specs):
                    seen["admitted"] += 1
                    build_megakernel_fn(specs)
                    residue = _residue(specs)
                    if residue is not None:
                        seen["classes"][residue] += 1
    assert seen["admitted"] == seen["runs"] == 1884, seen
    assert all(count > 0 for count in seen["classes"].values()), seen
