"""Shared base of the SGD-trained linear family — twin of
``flink_ml_tpu/models/linear.py``.

fit = extract columns → ``SGD.optimize`` with the subclass's loss from a
zero coefficient → the model class carrying the coefficient (the shape of
the reference's ``LogisticRegression.java:60-124``).
"""
from __future__ import annotations

from typing import Optional, Type

import numpy as np

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.models.common import ModelArraysMixin, extract_labeled_data
from flink_ml_tpu_torch.ops.lossfunc import LossFunc
from flink_ml_tpu_torch.ops.optimizer import SGD
from flink_ml_tpu_torch.params.param import update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasReg,
    HasTol,
    HasWeightCol,
)

from flink_ml_tpu_torch.ops.kernels import compute_dots  # noqa: F401 — re-exported as in the JAX package

__all__ = ["LinearEstimatorBase", "LinearModelBase", "compute_dots"]


class LinearModelBase(ModelArraysMixin, Model, HasFeaturesCol, HasPredictionCol):
    """A fitted linear model: its state is the ``coefficient`` vector."""

    _MODEL_ARRAY_NAMES = ("coefficient",)

    def __init__(self):
        super().__init__()
        self.coefficient: Optional[np.ndarray] = None


class LinearEstimatorBase(
    Estimator,
    HasFeaturesCol,
    HasLabelCol,
    HasWeightCol,
    HasPredictionCol,
    HasMaxIter,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
    HasReg,
    HasElasticNet,
):
    """fit = extract columns → SGD with the subclass loss → model carrying coef."""

    _LOSS: LossFunc = None
    _MODEL_CLASS: Type[LinearModelBase] = None

    def _make_optimizer(self, device) -> SGD:
        return SGD(
            max_iter=self.get_max_iter(),
            learning_rate=self.get_learning_rate(),
            global_batch_size=self.get_global_batch_size(),
            tol=self.get_tol(),
            reg=self.get_reg(),
            elastic_net=self.get_elastic_net(),
            device=device,
        )

    def fit(self, *inputs, device=None) -> LinearModelBase:
        """Train on ``device`` (None → the GPU). Records ``loss_history``
        and ``onehot_premat_active`` of the run on the estimator."""
        (df,) = inputs
        data = extract_labeled_data(
            df, self.get_features_col(), self.get_label_col(), self.get_weight_col(),
            allow_sparse=True,
        )
        self._validate_labels(data["labels"])
        dim = data.pop("dim", None) or data["features"].shape[1]
        optimizer = self._make_optimizer(device)
        coefficient = optimizer.optimize(np.zeros(dim, np.float32), data, self._LOSS)
        self.loss_history = list(optimizer.loss_history)
        self.onehot_premat_active = optimizer.onehot_premat_active
        model = self._MODEL_CLASS()
        update_existing_params(model, self)
        model.coefficient = np.asarray(coefficient)
        return model

    def _validate_labels(self, labels: np.ndarray) -> None:
        pass
