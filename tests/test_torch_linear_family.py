"""LinearSVC and LinearRegression in the port against the JAX package on the
CPU: fit and transform on dense rows, on sparse rows through the scatter
path and on sparse rows the 'auto' gate sends down the one-hot path
(d = 2^14), the label check, ``compute_dots``, and saved directories loaded
across both packages.

Tolerances, each with its reason:
- coefficients within 1e-6 absolute of the JAX fit (float32 SGD whose
  sums round in another order; the one-hot path's crossings sum the same
  split-bf16 terms in another order);
- margins (rawPrediction, LinearRegression's prediction) within 1e-5
  relative and 1e-6 absolute of the JAX transform on the same coefficient
  (float32 dots in another order); LinearSVC's prediction exactly, on the
  rows whose float64 margin is more than 1e-4 from the threshold.
The JAX side runs on a one-device mesh, so its local batch is the port's.
"""
import numpy as np
import pytest
import torch

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.linearsvc import (
    LinearSVC as JLinearSVC,
    LinearSVCModel as JLinearSVCModel,
)
from flink_ml_tpu.models.linear import compute_dots as jcompute_dots
from flink_ml_tpu.models.regression.linear_regression import (
    LinearRegression as JLinearRegression,
    LinearRegressionModel as JLinearRegressionModel,
)
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.linalg.vectors import SparseVector
from flink_ml_tpu_torch.models.classification.linearsvc import LinearSVC, LinearSVCModel
from flink_ml_tpu_torch.models.linear import compute_dots
from flink_ml_tpu_torch.models.regression.linear_regression import LinearRegression, LinearRegressionModel
from flink_ml_tpu_torch.utils import read_write as rw

torch.set_num_threads(1)

MARGIN = 1e-4
FAMILY = {
    "svc": (LinearSVC, JLinearSVC, LinearSVCModel, JLinearSVCModel),
    "linreg": (LinearRegression, JLinearRegression, LinearRegressionModel, JLinearRegressionModel),
}


def _frames(kind, seed, n, d, nnz=None):
    """Port and JAX DataFrames of the same rows: dense [n, d], or SparseVector
    rows of ``nnz`` distinct features; labels {0, 1} for the SVC, real for
    the regression."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    if nnz is None:
        X = rng.normal(size=(n, d))
        port_feats = ref_feats = X
        margin = X @ w_true
    else:
        rows = [np.sort(rng.choice(d, nnz, replace=False)) for _ in range(n)]
        vals = rng.normal(size=(n, nnz))
        port_feats = [SparseVector(d, r, v) for r, v in zip(rows, vals)]
        ref_feats = [JSparseVector(d, r, v) for r, v in zip(rows, vals)]
        margin = np.array([v @ w_true[r] for r, v in zip(rows, vals)])
    y = (margin > 0).astype(np.float64) if kind == "svc" else margin + 0.1 * rng.normal(size=n)
    return (DataFrame.from_dict({"features": port_feats, "label": y}),
            JDataFrame.from_dict({"features": ref_feats, "label": y}))


def _configure(est, iters, batch, lr):
    return est.set_max_iter(iters).set_global_batch_size(batch).set_learning_rate(lr).set_tol(0.0).set_reg(0.01)


def _fit_both(kind, frames, iters, batch, lr):
    Est, JEst, _, _ = FAMILY[kind]
    port_df, ref_df = frames
    est = _configure(Est(), iters, batch, lr)
    model = est.fit(port_df, device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jest = _configure(JEst(), iters, batch, lr)
        jmodel = jest.fit(ref_df)
    return est, model, jest, jmodel


def _hold_transform(kind, model, jmodel, frames):
    port_df, ref_df = frames
    out = model.transform(port_df, device="cpu")
    ref = jmodel.transform(ref_df)
    dots = np.asarray(jcompute_dots(ref_df, "features", jmodel.coefficient), np.float64)
    if kind == "svc":
        np.testing.assert_allclose(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction")),
                                   rtol=1e-5, atol=1e-6)
        decided = np.abs(dots) > MARGIN
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(np.asarray(out.column("prediction"))[decided],
                                      np.asarray(ref.column("prediction"))[decided])
    else:
        np.testing.assert_allclose(out.column("prediction"), np.asarray(ref.column("prediction")),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["svc", "linreg"])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_fit_and_transform_match_the_jax_package(kind, layout):
    frames = _frames(kind, 11 + len(layout), 300, 24 if layout == "dense" else 64,
                     None if layout == "dense" else 6)
    est, model, jest, jmodel = _fit_both(kind, frames, 12, 64, 0.1)
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    np.testing.assert_allclose(model.coefficient, np.asarray(jmodel.coefficient), rtol=0, atol=1e-6)
    np.testing.assert_allclose(est.loss_history, jest.loss_history, rtol=1e-5)
    assert not est.onehot_premat_active
    # the same coefficient in both packages: the transforms alone
    jmodel.coefficient = np.asarray(model.coefficient)
    _hold_transform(kind, model, jmodel, frames)


ONEHOT_D, ONEHOT_N, ONEHOT_NNZ, ONEHOT_BATCH = 1 << 14, 8192, 8, 1024


@pytest.fixture(scope="module", params=["svc", "linreg"])
def onehot_fit(request):
    """d = 2^14, 8192 rows of 8 features: 2^16 index slots, the least the
    'auto' gate sends down the one-hot path."""
    kind = request.param
    frames = _frames(kind, 21, ONEHOT_N, ONEHOT_D, ONEHOT_NNZ)
    return kind, frames, _fit_both(kind, frames, 6, ONEHOT_BATCH, 0.3)


def test_onehot_path_fit_and_transform_match_the_jax_package(onehot_fit):
    kind, frames, (est, model, jest, jmodel) = onehot_fit
    assert est.onehot_premat_active and jest.loss_history
    np.testing.assert_allclose(model.coefficient, np.asarray(jmodel.coefficient), rtol=0, atol=1e-6)
    np.testing.assert_allclose(est.loss_history, jest.loss_history, rtol=1e-5)
    jmodel.coefficient = np.asarray(model.coefficient)
    _hold_transform(kind, model, jmodel, tuple(f.take(np.arange(512)) for f in frames))


def test_label_check_refuses_what_the_jax_package_refuses():
    port_df, ref_df = _frames("linreg", 31, 40, 4)
    with pytest.raises(ValueError, match="binary labels"):
        LinearSVC().fit(port_df, device="cpu")
    with pytest.raises(ValueError, match="binary labels"):
        JLinearSVC().fit(ref_df)
    LinearRegression().set_max_iter(2).fit(port_df, device="cpu")  # real labels are fine


def test_threshold_and_compute_dots_equal_the_jax_package():
    port_df, ref_df = _frames("svc", 32, 50, 6)
    coef = np.random.default_rng(33).normal(size=6).astype(np.float32)
    dots = compute_dots(port_df, "features", coef, torch.device("cpu"))
    np.testing.assert_allclose(dots.numpy(), np.asarray(jcompute_dots(ref_df, "features", coef)),
                               rtol=1e-5, atol=1e-6)
    threshold = float(np.sort(dots.numpy())[25])  # a row exactly at the threshold
    model, jmodel = LinearSVCModel().set_threshold(threshold), JLinearSVCModel().set_threshold(threshold)
    model.coefficient = jmodel.coefficient = coef
    out = model.transform(port_df, device="cpu")
    assert np.asarray(out.column("prediction")).sum() == 25  # dots >= threshold: 25 of 50
    np.testing.assert_array_equal(out.column("rawPrediction")[:, 0], -out.column("rawPrediction")[:, 1])
    sparse_port, _ = _frames("svc", 34, 5, 10, 3)
    with pytest.raises(ValueError, match="features dim 10 != model dim 6"):
        compute_dots(sparse_port, "features", coef, torch.device("cpu"))


@pytest.mark.parametrize("kind", ["svc", "linreg"])
def test_saved_directories_load_across_both_packages(kind, tmp_path):
    Est, JEst, Model, JModel = FAMILY[kind]
    frames = _frames(kind, 41, 120, 8)
    est, model, jest, jmodel = _fit_both(kind, frames, 4, 32, 0.1)
    if kind == "svc":
        model.set_threshold(0.25)
        jmodel.set_threshold(0.25)
    model.save(str(tmp_path / "port"))
    jmodel.save(str(tmp_path / "jax"))
    from_jax = rw.load_stage(str(tmp_path / "jax"))
    from_port = JModel.load(str(tmp_path / "port"))
    assert isinstance(from_jax, Model) and isinstance(Model.load(str(tmp_path / "port")), Model)
    np.testing.assert_array_equal(from_jax.coefficient, jmodel.coefficient)
    np.testing.assert_array_equal(from_port.coefficient, model.coefficient)
    assert from_jax.param_map_to_json() == jmodel.param_map_to_json()
    assert from_port.param_map_to_json() == model.param_map_to_json()
    _hold_transform(kind, from_jax, jmodel, frames)  # the JAX model, transformed by both packages
    est.save(str(tmp_path / "port_est"))
    jest.save(str(tmp_path / "jax_est"))
    assert isinstance(rw.load_stage(str(tmp_path / "jax_est")), Est)
    assert jrw.load_stage(str(tmp_path / "port_est")).param_map_to_json() == est.param_map_to_json()
    from flink_ml_tpu_torch.servable import load_servable

    with pytest.raises(ValueError, match="no port class"):  # neither package has its servable
        load_servable(str(tmp_path / "jax"))
