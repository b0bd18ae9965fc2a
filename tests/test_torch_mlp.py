"""The port's MLP slice against the JAX package on the CPU: ``mlp_predict_fn``,
StandardScaler fit and transform, MLPClassifierModel.transform (float32 and
bfloat16), MLPClassifier.fit on a one-device mesh, the servable, the serving
plan in both fusion tiers (the JAX megakernel in Pallas interpret mode, as
``tests/test_fusion.py`` runs it), the server, StandardScaler → MLPClassifier
saved in one package and loaded in the other, and the ``rowlocal_mlp``
wrapper's device rule. Tests of the CUDA kernel itself are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- ``scale_fn`` output and the scaler's transform: bit-equal (two correctly
  rounded float32 operations in both packages);
- the scaler's fitted mean and std: rtol 1e-6 (float32 column sums taken in
  another order, then float64 on the host);
- float32 probabilities and losses: within ``ULP_ENVELOPE["scale_mlp"]``
  (16,384 ulps, about 2^-9 relative), the fast tier's promise for this
  chain — the matrix products sum in another order in the two frameworks;
  predictions equal where the top two logits differ by more than 1e-4;
- the fit: initial weights bit-equal (the same numpy draws); the loss
  history within rtol 1e-5 and the fitted model's probabilities within atol
  1e-5 — a few epochs of adam on float32 gradients whose last bits differ
  (measured: 3e-7 and 9e-7 at these sizes);
- bfloat16, one model: probabilities within atol 2e-2 and predictions equal
  where the float32 top-two gap exceeds 0.1 — the two frameworks round the
  bfloat16 products' accumulations at different points, one bfloat16 ulp
  (2^-8) of a logit apart;
- bfloat16, the fit: loss history rtol 1e-2, probabilities atol 5e-2 and
  predictions equal where the top-two gap exceeds 0.5 — a gradient near zero
  can round to either sign in bfloat16, and adam then moves its parameter by
  about ±lr either way (measured: weights 0.014 apart after 6 epochs at lr
  0.05, loss 2.3e-3 and probabilities 0.023 apart).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel
from flink_ml_tpu.models.classification.mlp_classifier import (
    MLPClassifier as JMLPClassifier,
    MLPClassifierModel as JMLPClassifierModel,
    _init_params as jinit_params,
)
from flink_ml_tpu.models.feature.standard_scaler import (
    StandardScaler as JStandardScaler,
    StandardScalerModel as JStandardScalerModel,
    _mean_std as jmean_std,
)
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan
from flink_ml_tpu.serving.server import InferenceServer as JServer, ServingConfig as JServingConfig

import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.classification.mlp_classifier import (
    MLPClassifier,
    MLPClassifierModel,
    _init_params,
)
from flink_ml_tpu_torch.models.feature.standard_scaler import (
    StandardScaler,
    StandardScalerModel,
    _mean_std,
)
from flink_ml_tpu_torch.ops.schedule import offset_schedule
from flink_ml_tpu_torch.servable import (
    MLPClassifierModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
    load_servable,
    servable_from_arrays,
)
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, FusionTier, ulp_diff
from flink_ml_tpu_torch.servable.megakernels import (
    ROWLOCAL_MLP,
    RowLocalOp,
    chain_eligible,
    rowlocal_mlp,
)
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

D, HIDDEN, CLASSES = 16, (32, 32), 4
ENVELOPE = ULP_ENVELOPE["scale_mlp"]
MARGIN = 1e-4
FLAGS = [(True, True), (True, False), (False, True), (False, False)]
NETWORKS = {"16-32-32-4": [16, 32, 32, 4], "16-4": [16, 4], "8-16-3": [8, 16, 3]}
COLUMNS = ("scaled", "prediction", "rawPrediction")


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets is unset after it: the test workers run
    other files in the same process."""
    yield
    config.unset(Options.TRAIN_MESH)
    config.unset(Options.TRAIN_MESH_MODEL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _layers(widths, seed):
    rng = np.random.default_rng(seed)
    return [
        ((rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32),
         (rng.normal(size=b) * 0.1).astype(np.float32))
        for a, b in zip(widths[:-1], widths[1:])
    ]


def _top_two_gap(logits):
    top = np.sort(np.asarray(logits, np.float64), axis=1)
    return top[:, -1] - top[:, -2]


def _logits(layers, X):
    h = np.asarray(X, np.float64)
    for W, b in layers[:-1]:
        h = np.maximum(h @ W + b, 0.0)
    return h @ layers[-1][0] + layers[-1][1]


def _data(n, seed, d=D, classes=CLASSES):
    """Rows with classes from a fixed random linear teacher, so they are learnable."""
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=1.0, scale=2.0, size=(n, d))
    y = np.argmax(X @ rng.normal(size=(d, classes)), axis=1).astype(np.float64) * 2.0 + 1.0
    return X, y


# ---------------------------------------------------------------------------
# mlp_predict_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_mlp_predict_fn_matches_jax(net):
    layers = _layers(NETWORKS[net], seed=len(net))
    X = np.random.default_rng(1).normal(size=(203, NETWORKS[net][0])).astype(np.float32)
    idx, probs = tk.mlp_predict_fn([(_t(W), _t(b)) for W, b in layers], _t(X))
    j_idx, j_probs = jk.mlp_predict_fn([(jnp.asarray(W), jnp.asarray(b)) for W, b in layers], X)
    assert idx.dtype == torch.float32 and probs.shape == (203, NETWORKS[net][-1])
    assert ulp_diff(probs.numpy(), np.asarray(j_probs)) <= ENVELOPE
    decided = _top_two_gap(_logits(layers, X)) > MARGIN
    np.testing.assert_array_equal(idx.numpy()[decided], np.asarray(j_idx)[decided])


def test_mlp_predict_fn_argmax_takes_the_first_maximum_and_nan():
    logits = np.array([[1.0, 3.0, 3.0], [np.nan, 5.0, np.nan], [-1.0, -1.0, -1.0]], np.float32)
    eye = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    idx, _ = tk.mlp_predict_fn([(_t(W), _t(b)) for W, b in eye], _t(logits))
    j_idx, _ = jk.mlp_predict_fn([(jnp.asarray(W), jnp.asarray(b)) for W, b in eye], logits)
    assert idx.tolist() == np.asarray(j_idx).tolist() == [1.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# StandardScaler
# ---------------------------------------------------------------------------


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


@pytest.mark.parametrize("with_mean,with_std", FLAGS)
def test_standard_scaler_fit_and_transform_match_jax(one_device_mesh, with_mean, with_std):
    X, _ = _data(301, seed=3)
    X[:, 2] = 7.0  # a constant feature: std 0, scaled to 0
    X[:, 3] += 1e4  # |mean| >> std: the centered second moment does not cancel
    est = StandardScaler().set_input_col("features").set_output_col("scaled")
    jest = JStandardScaler().set_input_col("features").set_output_col("scaled")
    for e in (est, jest):
        e.set_with_mean(with_mean).set_with_std(with_std)
    model = est.fit(DataFrame.from_dict({"features": X}), device="cpu")
    jmodel = jest.fit(JDataFrame.from_dict({"features": X}))
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    np.testing.assert_allclose(model.mean, jmodel.mean, rtol=1e-6)
    np.testing.assert_allclose(model.std, jmodel.std, rtol=1e-6, atol=1e-12)
    assert model.std[2] == 0.0
    np.testing.assert_allclose(model.std, X.std(axis=0, ddof=1), rtol=1e-4, atol=1e-5)
    # the same model in both packages transforms bit for bit
    model.mean, model.std = jmodel.mean, jmodel.std
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_array_equal(out.column("scaled"), np.asarray(ref.column("scaled")))
    spec = model.kernel_spec()
    assert spec.fusion_op == "scale" and spec.fusion_params == {"with_mean": with_mean, "with_std": with_std}


def test_standard_scaler_edge_cases_match_jax():
    for a, b in ((np.arange(4.0), np.arange(4.0) ** 2 + 1), (np.ones(3), np.ones(3))):
        for n in (1.0, 5.0):
            for port, ref in zip(_mean_std(a, b, n), jmean_std(a, b, n)):
                np.testing.assert_array_equal(port, ref)
    one = StandardScaler().fit(DataFrame.from_dict({"input": np.ones((1, 3))}), device="cpu")
    np.testing.assert_array_equal(one.std, np.zeros(3))
    with pytest.raises(RuntimeError, match="empty"):
        StandardScaler().fit(DataFrame.from_dict({"input": np.zeros((0, 3))}), device="cpu")
    with pytest.raises(RuntimeError, match="fit/loaded"):
        StandardScalerModel().kernel_spec()


# ---------------------------------------------------------------------------
# MLPClassifierModel.transform, float32 and bfloat16
# ---------------------------------------------------------------------------


def _model_pair(widths, seed, compute_type="float32"):
    layers = _layers(widths, seed)
    labels = np.arange(widths[-1], dtype=np.float64) * 2.0 + 1.0
    jmodel = JMLPClassifierModel()
    jmodel.params, jmodel.labels = [tuple(layer) for layer in layers], labels
    model = MLPClassifierModel().set_model_data(*jmodel.get_model_data())
    for m in (model, jmodel):
        m.set_compute_type(compute_type)
    return model, jmodel, layers


@pytest.mark.parametrize("compute_type", ("float32", "bfloat16"))
def test_mlp_model_transform_matches_jax(compute_type):
    model, jmodel, layers = _model_pair([D, *HIDDEN, CLASSES], seed=4, compute_type=compute_type)
    X = np.random.default_rng(5).normal(size=(129, D))
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    probs, j_probs = out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))
    gap = _top_two_gap(_logits(layers, X.astype(np.float32)))
    if compute_type == "float32":
        assert ulp_diff(probs, j_probs) <= ENVELOPE
        decided = gap > MARGIN
    else:
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=2e-2)
        decided = gap > 0.1
    np.testing.assert_array_equal(out.column("prediction")[decided],
                                  np.asarray(ref.column("prediction"))[decided])
    assert out.column("prediction").dtype == np.float64 and probs.shape == (129, CLASSES)
    assert set(out.column("prediction")) <= set(model.labels)


def test_model_data_crosses_between_the_packages():
    model, jmodel, layers = _model_pair([D, *HIDDEN, CLASSES], seed=6)
    for (W, b), (pW, pb) in zip(layers, model.params):
        assert pW.dtype == np.float32 and np.array_equal(W, pW) and np.array_equal(b, pb)
    back = JMLPClassifierModel().set_model_data(*model.get_model_data())
    for (W, b), (jW, jb) in zip(layers, back.params):
        np.testing.assert_array_equal(W, jW)
        np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(back.labels, jmodel.labels)


# ---------------------------------------------------------------------------
# MLPClassifier.fit against the JAX fit on a one-device mesh
# ---------------------------------------------------------------------------

N_FIT, BATCH, ITERS, LR = 700, 256, 6, 0.05


def _jax_loss_history(ctx, X, y_idx, widths, seed, compute_type):
    """The JAX package's per-epoch mean loss: its epoch program driven one
    epoch at a time on the fit's schedule (its fit records no history)."""
    dtype = jnp.bfloat16 if compute_type == "bfloat16" else None
    opt = optax.adam(LR)
    step = jax.jit(jax.shard_map(
        JMLPClassifier._epoch_math(opt, BATCH, dtype, data_axes=ctx.data_axes),
        mesh=ctx.mesh,
        in_specs=(P(), P(), P(), P(), P(ctx.data_axes), P(ctx.data_axes), P(ctx.data_axes)),
        out_specs=(P(), P(), P()),
    ))
    params = [tuple(jnp.asarray(a) for a in layer)
              for layer in jinit_params(np.random.default_rng(seed), widths)]
    state = opt.init(params)
    Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y_idx, jnp.float32)
    wj = jnp.ones(len(X), jnp.float32)
    history = []
    for start, offset in zip(*offset_schedule(len(X), BATCH, ITERS)):
        params, state, loss = step(params, state, jnp.int32(start), jnp.int32(offset), Xj, yj, wj)
        history.append(float(loss))
    return history


@pytest.fixture(scope="module", params=("float32", "bfloat16"))
def fitted(request):
    compute_type = request.param
    X, y = _data(N_FIT, seed=7)
    widths = [D, *HIDDEN, CLASSES]

    def configure(est):
        return (est.set_hidden_layers(*HIDDEN).set_max_iter(ITERS).set_global_batch_size(BATCH)
                .set_learning_rate(LR).set_tol(0.0).set_seed(11).set_compute_type(compute_type))

    est = configure(MLPClassifier())
    model = est.fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        jmodel = configure(JMLPClassifier()).fit(JDataFrame.from_dict({"features": X, "label": y}))
        history = _jax_loss_history(ctx, X, (y - 1.0) / 2.0, widths, 11, compute_type)
    return compute_type, est, model, jmodel, history


def test_initial_weights_are_bit_equal():
    dims = [D, *HIDDEN, CLASSES]
    for seed in (0, 11):
        for (W, b), (jW, jb) in zip(_init_params(np.random.default_rng(seed), dims),
                                    jinit_params(np.random.default_rng(seed), dims)):
            assert W.dtype == np.float32
            np.testing.assert_array_equal(W, jW)
            np.testing.assert_array_equal(b, jb)


def test_mlp_fit_matches_the_jax_fit(fitted):
    compute_type, est, model, jmodel, history = fitted
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    np.testing.assert_array_equal(model.labels, jmodel.labels)
    assert len(est.loss_history) == ITERS
    rtol = 1e-5 if compute_type == "float32" else 1e-2
    np.testing.assert_allclose(est.loss_history, history, rtol=rtol)
    assert est.loss_history[-1] < est.loss_history[0]
    X = np.random.default_rng(8).normal(loc=1.0, scale=2.0, size=(97, D))
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    atol, margin = (1e-5, MARGIN) if compute_type == "float32" else (5e-2, 0.5)
    np.testing.assert_allclose(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction")),
                               rtol=0, atol=atol)
    logits = _logits([(np.asarray(W, np.float64), np.asarray(b, np.float64)) for W, b in jmodel.params], X)
    decided = _top_two_gap(logits) > margin
    np.testing.assert_array_equal(out.column("prediction")[decided],
                                  np.asarray(ref.column("prediction"))[decided])


def test_tol_stops_the_fit_where_the_jax_fit_stops(one_device_mesh):
    X, y = _data(N_FIT, seed=9)
    est = (MLPClassifier().set_hidden_layers(*HIDDEN).set_max_iter(200).set_global_batch_size(BATCH)
           .set_learning_rate(LR).set_tol(0.5))
    jest = (JMLPClassifier().set_hidden_layers(*HIDDEN).set_max_iter(200).set_global_batch_size(BATCH)
            .set_learning_rate(LR).set_tol(0.5))
    model = est.fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    jmodel = jest.fit(JDataFrame.from_dict({"features": X, "label": y}))
    # stopped mid-chunk: every recorded loss but the last is at or above tol
    assert 1 < len(est.loss_history) < 64
    assert est.loss_history[-1] < 0.5 <= min(est.loss_history[:-1])
    Xt = np.random.default_rng(10).normal(loc=1.0, scale=2.0, size=(50, D))
    np.testing.assert_allclose(
        model.transform(DataFrame.from_dict({"features": Xt}), device="cpu").column("rawPrediction"),
        np.asarray(jmodel.transform(JDataFrame.from_dict({"features": Xt})).column("rawPrediction")),
        rtol=0, atol=1e-4,
    )


def test_unported_training_tiers_raise_naming_the_roadmap():
    X, y = _data(64, seed=12)
    # fit_stream is ported (queue A 7): with no cache it fails as the JAX
    # fit_stream does, reading the cache's labels
    with pytest.raises(AttributeError, match="iter_rows"):
        MLPClassifier().fit_stream(None, device="cpu")
    with pytest.raises(AttributeError, match="iter_rows"):
        JMLPClassifier().fit_stream(None)
    config.set(Options.TRAIN_MESH, 2)
    # the sharded tier is ported: a mesh of 2 needs a world of 2 ranks
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        MLPClassifier().fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    # tensor parallelism is too: a 2 x 2 mesh needs a world of 4 ranks
    config.set(Options.TRAIN_MESH_MODEL, 2)
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        MLPClassifier().fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")


# ---------------------------------------------------------------------------
# the servable and the serving plan against the JAX package
# ---------------------------------------------------------------------------


def _pipelines(widths, with_mean=True, with_std=True, seed=13):
    rng = np.random.default_rng(seed)
    mean, std = rng.normal(size=widths[0]), np.abs(rng.normal(size=widths[0])) + 0.5
    std[1] = 0.0  # the zero-std guard
    arrays = {"labels": np.arange(widths[-1], dtype=np.float64) * 2.0 + 1.0}
    for i, (W, b) in enumerate(_layers(widths, seed)):
        arrays[f"W{i}"], arrays[f"b{i}"] = W, b

    def build(sc_cls, mlp_cls, pipe_cls):
        sc = sc_cls().set_input_col("features").set_output_col("scaled")
        sc.set_with_mean(with_mean)
        sc.set_with_std(with_std)
        sc.mean, sc.std = mean, std
        mlp = mlp_cls().set_features_col("scaled")
        mlp._apply_model_arrays(arrays)
        return pipe_cls([sc, mlp])

    return (
        build(StandardScalerModelServable, MLPClassifierModelServable, PipelineModelServable),
        build(jlib.StandardScalerModelServable, jlib.MLPClassifierModelServable, JPipeline),
    )


def _assert_same_answers(port_df, jax_df, layers, where=""):
    scaled = np.asarray(jax_df.column("scaled"))
    np.testing.assert_array_equal(port_df.column("scaled"), scaled, err_msg=where)
    u = ulp_diff(port_df.column("rawPrediction"), np.asarray(jax_df.column("rawPrediction")))
    assert u <= ENVELOPE, f"{where}: probabilities moved {u} ulps"
    decided = _top_two_gap(_logits(layers, scaled.astype(np.float32))) > MARGIN
    np.testing.assert_array_equal(port_df.column("prediction")[decided],
                                  np.asarray(jax_df.column("prediction"))[decided], err_msg=where)


@pytest.mark.parametrize("net", sorted(NETWORKS))
def test_servable_matches_jax(net):
    port_pipe, jax_pipe = _pipelines(NETWORKS[net])
    X = np.random.default_rng(14).normal(size=(77, NETWORKS[net][0]))
    mlp, jmlp = port_pipe.servables[1], jax_pipe.servables[1]
    assert mlp.param_map_to_json() == jmlp.param_map_to_json()
    out = port_pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jax_pipe.transform(JDataFrame.from_dict({"features": X}))
    _assert_same_answers(out, ref, mlp.layers, net)
    spec = mlp.kernel_spec()
    assert spec.fusion_op == "mlp" and spec.model_arrays["labels"].dtype == np.float32
    assert set(spec.model_arrays) == set(jmlp.kernel_spec().model_arrays)
    assert chain_eligible([port_pipe.servables[0].kernel_spec(), spec])


@pytest.mark.parametrize("net", sorted(NETWORKS))
@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True)])
def test_plan_tiers_match_jax_exact_and_megakernel_tiers(net, with_mean, with_std):
    """The port's exact tier equals its per-stage transform bit for bit, its
    fast tier's megakernel program (the plain version on CPU tensors) the
    per-stage transform too; both within the envelope of the JAX exact
    plan and of the JAX Pallas megakernel in interpret mode."""
    widths = NETWORKS[net]
    port_pipe, jax_pipe = _pipelines(widths, with_mean, with_std)
    n = 203  # odd: the JAX megakernel's single-tile tail path
    X = np.random.default_rng(15).normal(size=(n, widths[0]))
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    per_stage = port_pipe.transform(df, device="cpu")
    exact = CompiledServingPlan.build(port_pipe, scope=f"tm-e{net}", device="cpu").execute(df)
    mega_plan = CompiledServingPlan.build(port_pipe, scope=f"tm-m{net}", device="cpu",
                                          fusion=FusionTier("fast", min_score=1.0))
    mega = mega_plan.execute(df)
    assert chain_kinds(mega_plan) == {n: ("megakernel",)}
    j_exact = JPlan.build(jax_pipe, scope=f"tmj-e{net}").execute(jdf)
    j_plan = JPlan.build(jax_pipe, scope=f"tmj-m{net}", fusion=JFusionTier("fast", min_score=1.0))
    j_mega = j_plan.execute(jdf)
    assert "fast+mega" in {s.plan_label(n) for s in j_plan.segments}
    layers = port_pipe.servables[1].layers
    for name in COLUMNS:
        np.testing.assert_array_equal(exact.column(name), per_stage.column(name))
        np.testing.assert_array_equal(mega.column(name), per_stage.column(name))
        assert mega.column(name).dtype == np.float64
    for ref, tier in ((j_exact, "exact"), (j_mega, "fast+mega")):
        _assert_same_answers(mega, ref, layers, f"{tier} {net}")


def test_mlp_alone_is_one_megakernel_chain():
    port_pipe, jax_pipe = _pipelines(NETWORKS["16-32-32-4"])
    mlp = port_pipe.servables[1].set_features_col("features")
    jax_pipe.servables[1].set_features_col("features")
    X = np.random.default_rng(16).normal(size=(33, D))
    plan = CompiledServingPlan.build(mlp, scope="tm-alone", device="cpu",
                                     fusion=FusionTier("fast", min_score=1.0))
    out = plan.execute(DataFrame.from_dict({"features": X}))
    assert chain_kinds(plan) == {33: ("megakernel",)}
    ref = jax_pipe.servables[1].transform(JDataFrame.from_dict({"features": X}))
    assert ulp_diff(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))) <= ENVELOPE
    np.testing.assert_array_equal(out.column("rawPrediction"),
                                  mlp.transform(DataFrame.from_dict({"features": X}), device="cpu")
                                  .column("rawPrediction"))


def test_cost_model_marks_the_published_network_hot_from_two_rows():
    """256 → 512 → 512 → 8 behind the scaler scores 798,240 per row against
    the default bar of 10^6: every bucket from 2 rows runs the megakernel."""
    from flink_ml_tpu_torch.servable.fusion import chain_score

    port_pipe, _ = _pipelines([256, 512, 512, 8])
    specs = [s.kernel_spec() for s in port_pipe.servables]
    assert chain_score(specs, 1, width=256) == 798_240
    tier = FusionTier("fast")
    assert not tier.megakernel_hot(specs, 1, 256) and tier.megakernel_hot(specs, 2, 256)


def test_port_and_jax_servers_answer_the_same_stream():
    port_pipe, jax_pipe = _pipelines(NETWORKS["16-32-32-4"])
    layers = port_pipe.servables[1].layers
    rng = np.random.default_rng(17)
    sizes = [1, 3, 16, 9, 64, 33, 2]
    payloads = [rng.normal(size=(n, D)) for n in sizes]
    template = payloads[0][:1]
    port_cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    jax_cfg = JServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    with InferenceServer(port_pipe, name="tm-pair", serving_config=port_cfg, device="cpu",
                         warmup_template=DataFrame.from_dict({"features": template})) as port, \
            JServer(jax_pipe, name="tm-pair-jax", serving_config=jax_cfg,
                    warmup_template=JDataFrame.from_dict({"features": template})) as ref:
        for i, x in enumerate(payloads):  # one request at a time: batching is deterministic
            a = port.predict(DataFrame.from_dict({"features": x}))
            b = ref.predict(JDataFrame.from_dict({"features": x}))
            assert a.bucket == b.bucket
            _assert_same_answers(a.dataframe, b.dataframe, layers, f"request {i} ({len(x)} rows)")
    kinds = chain_kinds(port_pipe._fastpath_plan)
    # 16 → 32 → 32 → 4 scores 2,788 per row behind the scaler: the default bar
    # of 10^6 is not reached at 64 rows, so every bucket runs the merged program
    assert set(kinds.values()) == {("fused",)}
    assert metrics.get(port.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 0
    assert metrics.get(port.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0


def test_server_runs_the_megakernel_program_for_hot_buckets():
    port_pipe, _ = _pipelines([64, 512, 512, 8])
    rng = np.random.default_rng(18)
    cfg = ServingConfig(max_batch_size=8, max_delay_ms=0.5, fusion_mode="fast")
    template = DataFrame.from_dict({"features": rng.normal(size=(1, 64))})
    with InferenceServer(port_pipe, name="tm-hot", serving_config=cfg, device="cpu",
                         warmup_template=template) as srv:
        payloads = [rng.normal(size=(n, 64)) for n in (1, 2, 5, 8)]
        responses = [srv.predict(DataFrame.from_dict({"features": x})) for x in payloads]
    kinds = chain_kinds(port_pipe._fastpath_plan)
    assert kinds[1] == ("fused",) and kinds[2] == kinds[8] == ("megakernel",)
    for x, resp in zip(payloads, responses):
        ref = port_pipe.transform(DataFrame.from_dict({"features": x}), device="cpu")
        for name in COLUMNS:
            np.testing.assert_array_equal(resp.dataframe.column(name), ref.column(name))
    assert metrics.get(srv.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 0
    assert metrics.get(srv.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0


# ---------------------------------------------------------------------------
# StandardScaler → MLPClassifier saved in one package, loaded in the other
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    X, y = _data(300, seed=19)
    df, jdf = DataFrame.from_dict({"features": X, "label": y}), JDataFrame.from_dict({"features": X, "label": y})
    scaler = StandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    jscaler = JStandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    sc_model = scaler.fit(df, device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jsc_model = jscaler.fit(jdf)
        jmlp_model = (JMLPClassifier().set_features_col("scaled").set_hidden_layers(*HIDDEN)
                      .set_max_iter(3).set_global_batch_size(128).set_learning_rate(LR)
                      .fit(jsc_model.transform(jdf)))
    mlp_model = (MLPClassifier().set_features_col("scaled").set_hidden_layers(*HIDDEN)
                 .set_max_iter(3).set_global_batch_size(128).set_learning_rate(LR)
                 .fit(sc_model.transform(df, device="cpu"), device="cpu"))
    root = tmp_path_factory.mktemp("mlp")
    paths = {}
    for name, stage in (("sc", sc_model), ("mlp", mlp_model), ("jsc", jsc_model), ("jmlp", jmlp_model)):
        paths[name] = str(root / name)
        stage.save(paths[name])
    JPipelineModel([jsc_model, jmlp_model]).save(str(root / "jpipe"))
    paths["jpipe"] = str(root / "jpipe")
    return paths, (sc_model, mlp_model, jsc_model, jmlp_model), X


def test_jax_saved_models_load_into_the_port(saved):
    paths, (_, _, jsc_model, jmlp_model), X = saved
    sc = rw.load_stage(paths["jsc"])
    mlp = rw.load_stage(paths["jmlp"])
    assert isinstance(sc, StandardScalerModel) and isinstance(mlp, MLPClassifierModel)
    np.testing.assert_array_equal(sc.mean, jsc_model.mean)
    for (W, b), (jW, jb) in zip(mlp.params, jmlp_model.params):
        np.testing.assert_array_equal(W, jW)
        np.testing.assert_array_equal(b, jb)
    assert mlp.param_map_to_json() == jmlp_model.param_map_to_json()
    pipe = load_servable(paths["jpipe"])
    assert [type(s) for s in pipe.servables] == [StandardScalerModelServable, MLPClassifierModelServable]
    out = pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = JPipelineModel([jsc_model, jmlp_model]).transform(JDataFrame.from_dict({"features": X}))
    _assert_same_answers(out, ref, pipe.servables[1].layers, "JAX pipeline in the port")


def test_port_saved_models_load_into_the_jax_package(saved):
    paths, (sc_model, mlp_model, _, _), X = saved
    # the JAX servables read a port-written directory and ignore its class name
    jpipe = JPipeline([jlib.StandardScalerModelServable.load_servable(paths["sc"]),
                       JMLPClassifierModel.load_servable(paths["mlp"])])
    assert isinstance(jpipe.servables[1], jlib.MLPClassifierModelServable)
    port_pipe = PipelineModelServable([load_servable(paths["sc"]), load_servable(paths["mlp"])])
    assert isinstance(port_pipe.servables[1], MLPClassifierModelServable)
    out = port_pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jpipe.transform(JDataFrame.from_dict({"features": X}))
    _assert_same_answers(out, ref, port_pipe.servables[1].layers, "port models in JAX")
    direct = mlp_model.transform(sc_model.transform(DataFrame.from_dict({"features": X}), device="cpu"),
                                 device="cpu")
    for name in ("prediction", "rawPrediction"):
        np.testing.assert_array_equal(out.column(name), direct.column(name))
    reloaded = MLPClassifierModel.load(paths["mlp"])
    assert reloaded.param_map_to_json() == mlp_model.param_map_to_json()
    with pytest.raises(ValueError, match="does not match"):
        MLPClassifierModel.load(paths["sc"])
    from_memory = servable_from_arrays(
        "flink_ml_tpu.models.classification.mlp_classifier.MLPClassifierModel",
        mlp_model.param_map_to_json(), rw.load_model_arrays(paths["mlp"]),
    )
    np.testing.assert_array_equal(
        from_memory.transform(direct, device="cpu").column("rawPrediction"),
        direct.column("rawPrediction"),
    )


# ---------------------------------------------------------------------------
# the wrapper's device rule
# ---------------------------------------------------------------------------


def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_counting():
    widths = [D, *HIDDEN, CLASSES]
    layers = [(_t(W), _t(b)) for W, b in _layers(widths, seed=20)]
    labels = _t(np.arange(CLASSES) * 2.0 + 1.0)
    rng = np.random.default_rng(21)
    x, mean, inv_std = _t(rng.normal(size=(40, D))), _t(rng.normal(size=D)), _t(np.abs(rng.normal(size=D)))
    before = ROWLOCAL_MLP.launches
    for with_mean, with_std in FLAGS:
        kw = dict(with_mean=with_mean, with_std=with_std)
        scaled, pred, probs = rowlocal_mlp([x], [RowLocalOp("scale", 0, mean, inv_std, kw),
                                                 RowLocalOp("mlp", 1, labels, layers=layers)])
        want = tk.scale_fn(x, mean, inv_std, **kw)
        want_idx, want_probs = tk.mlp_predict_fn(layers, want)
        assert torch.equal(scaled, want) and torch.equal(probs, want_probs)
        assert torch.equal(pred, labels[want_idx.long()])
    pred, probs = rowlocal_mlp([x], [RowLocalOp("mlp", 0, labels, layers=layers)])  # the MLP alone
    assert pred.shape == (40,) and probs.shape == (40, CLASSES)
    assert set(pred.tolist()) <= set(labels.tolist())
    assert ROWLOCAL_MLP.launches == before  # the count is of kernel launches only


def test_wrapper_raises_for_tensors_it_has_no_path_for():
    layers = [(torch.empty((8, 3), device="meta"), torch.empty(3, device="meta"))]
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        rowlocal_mlp([torch.empty((4, 8), device="meta")],
                     [RowLocalOp("mlp", 0, torch.empty(3, device="meta"), layers=layers)])
