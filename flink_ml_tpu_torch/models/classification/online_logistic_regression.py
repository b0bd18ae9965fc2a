"""Online logistic regression by FTRL-proximal — twin of
``flink_ml_tpu/models/classification/online_logistic_regression.py``.

Reference: ``OnlineLogisticRegression.java`` — per global batch the
gradient of the sigmoid loss (``CalculateLocalGradient:300-334``), then the
FTRL update (``UpdateModel:222-253``), per dimension:

    σ = (√(n + g²) − √n)/α;  z += g − σ·w;  n += g²
    w = 0                                  if |z| ≤ l1
      = (sign(z)·l1 − z) / ((β + √n)/α + l2)  otherwise

with l1 = elasticNet·reg and l2 = (1 − elasticNet)·reg. Versions count
from 1, one a batch (``CreateLrModelData``); version 0 is the initial model.

The step (:func:`ftrl_step`) is the JAX package's in float32 — the
coefficient, n and z all float32, as JAX keeps them with x64 off — on the
estimator's device: ``sigmoid(X @ coef)``, the gradient ``Xᵀ(w·(p − y))``
over the weight sum, then the elementwise update. As in the JAX package,
sample weights scale the dense gradient too (the reference's dense branch
ignores its weight column). Each version's coefficient is read back to the
host: the model's payload is host numpy, as in the JAX package.

``OnlineLogisticRegressionModel`` appends prediction, rawPrediction and the
LONG version column; a published version serves as a
``LogisticRegressionModelServable`` (``load_servable``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.linalg.vectors import Vector
from flink_ml_tpu_torch.models.online import HasCheckpointing, OnlineModelBase, array_digest, as_batch_stream
from flink_ml_tpu_torch.ops.kernels import compute_dots, logistic_from_dots_fn
from flink_ml_tpu_torch.params.param import FloatParam, ParamValidators, update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasBatchStrategy,
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasModelVersionCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasWeightCol,
)
from flink_ml_tpu_torch.servable.lib import LogisticRegressionModelServable

__all__ = ["OnlineLogisticRegression", "OnlineLogisticRegressionModel", "ftrl_step"]


class _FtrlParams(HasReg, HasElasticNet, HasGlobalBatchSize, HasBatchStrategy):
    """OnlineLogisticRegressionParams: alpha and beta on the shared mixins."""

    ALPHA = FloatParam("alpha", "The alpha parameter of ftrl.", 0.1, ParamValidators.gt(0.0))
    BETA = FloatParam("beta", "The beta parameter of ftrl.", 0.1, ParamValidators.gt(0.0))

    def get_alpha(self) -> float:
        return self.get(self.ALPHA)

    def set_alpha(self, value: float):
        return self.set(self.ALPHA, value)

    def get_beta(self) -> float:
        return self.get(self.BETA)

    def set_beta(self, value: float):
        return self.set(self.BETA, value)


def ftrl_step(coef: torch.Tensor, n: torch.Tensor, z: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, alpha: float, beta: float, l1: float, l2: float):
    """One FTRL-proximal step on a batch ``X`` [rows, d], labels ``y`` and
    weights ``w`` [rows]: ``(coef, n, z)`` after it, in the inputs' dtype."""
    p = torch.sigmoid(X @ coef)
    grad = X.T @ (w * (p - y))
    weight_sum = torch.sum(w) * torch.ones_like(grad)
    g = torch.where(weight_sum != 0.0, grad / weight_sum, grad)
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / alpha
    z = z + g - sigma * coef
    n = n + g * g
    new_coef = torch.where(
        torch.abs(z) <= l1,
        torch.zeros_like(z),
        (torch.sign(z) * l1 - z) / ((beta + torch.sqrt(n)) / alpha + l2),
    )
    return new_coef, n, z


def _column(batch, name: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(batch[name], np.float32)).to(dev)


class OnlineLogisticRegressionModel(
    OnlineModelBase,
    HasFeaturesCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasModelVersionCol,
):
    """OnlineLogisticRegressionModel.java: serves the newest version and
    writes its number in the version column."""

    _MODEL_ARRAY_NAMES = ("coefficient",)

    def __init__(self):
        super().__init__()
        self.coefficient: Optional[np.ndarray] = None

    def _apply_snapshot(self, payload) -> None:
        self.coefficient = np.asarray(payload)

    @classmethod
    def load_servable(cls, path: str) -> LogisticRegressionModelServable:
        """A published version serves as a ``LogisticRegressionModelServable``
        (the same coefficient array and param names), so
        ``publish_servable(model, dir)`` feeds a server's poller straight
        from a live online fit."""
        return LogisticRegressionModelServable.load_servable(path)

    def transform(self, *inputs, device=None):
        """Predictions with the newest version on ``device`` (None → the GPU)."""
        (df,) = inputs
        if self.coefficient is None:
            raise RuntimeError("no model version has arrived yet; advance() the model or set model data")
        pred, raw = logistic_from_dots_fn(
            compute_dots(df, self.get_features_col(), self.coefficient, resolve_device(device)))
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        out.add_column(self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE),
                       raw.cpu().numpy().astype(np.float64))
        out.add_column(self.get_model_version_col(), DataTypes.LONG,
                       np.full(len(df), self.model_version, np.int64))
        return out


class OnlineLogisticRegression(
    Estimator,
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasPredictionCol,
    HasRawPredictionCol,
    _FtrlParams,
    HasCheckpointing,
):
    """OnlineLogisticRegression.java."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._initial_coefficient: Optional[np.ndarray] = None

    def set_initial_model_data(self, model_data: DataFrame) -> "OnlineLogisticRegression":
        """setInitialModelData: a model-data DataFrame whose ``coefficient``
        column's first row is the initial coefficient."""
        value = model_data.column("coefficient")[0]
        self._initial_coefficient = value.to_array() if isinstance(value, Vector) else np.asarray(value)
        return self

    def fit(self, *inputs, device=None) -> OnlineLogisticRegressionModel:
        """The online model over ``inputs[0]`` (a DataFrame, trained at once,
        or any stream of batches, trained by ``advance``), its steps on
        ``device`` (None → the GPU)."""
        (data,) = inputs
        if self._initial_coefficient is None:
            raise RuntimeError("OnlineLogisticRegression requires set_initial_model_data")
        dev = resolve_device(device)
        coef = torch.from_numpy(np.asarray(self._initial_coefficient, np.float32)).to(dev)
        dim = int(coef.shape[0])
        alpha, beta = self.get_alpha(), self.get_beta()
        l1 = self.get_elastic_net() * self.get_reg()
        l2 = (1.0 - self.get_elastic_net()) * self.get_reg()
        features_col, label_col = self.get_features_col(), self.get_label_col()
        weight_col = self.get_weight_col()

        stream, bounded = as_batch_stream(data, self.get_global_batch_size())

        def train_step(state, batch):
            coef, n, z = state
            X = _column(batch, features_col, dev)
            y = _column(batch, label_col, dev)
            w = _column(batch, weight_col, dev) if weight_col and weight_col in batch else torch.ones_like(y)
            with torch.no_grad():
                coef, n, z = ftrl_step(coef, n, z, X, y, w, alpha, beta, l1, l2)
            return (coef, n, z), coef.cpu().numpy()

        def place_state(state):  # a JAX-written snapshot holds arrays
            return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in state)

        zeros = torch.zeros(dim, dtype=torch.float32, device=dev)
        driver = self._snapshot_driver(
            stream,
            train_step,
            (coef, zeros, zeros.clone()),
            payload_from_state=lambda s: s[0].cpu().numpy(),
            place_state=place_state,
            device=dev,
            dim=dim,
            init=array_digest(self._initial_coefficient),
        )
        model = OnlineLogisticRegressionModel()
        update_existing_params(model, self)
        model._apply_snapshot(self._initial_coefficient)  # version 0: the initial model
        driver.resume_into(model)  # the checkpointed version, if any
        model._attach_stream(driver)
        if bounded:
            model.advance()
        return model
