"""Logistic regression — twin of
``flink_ml_tpu/models/classification/logistic_regression.py``.

Fit = SGD with ``BinaryLogisticLoss`` (``LogisticRegression.java:60-124``);
prediction = margin ≥ 0, rawPrediction = [1−p, p] with p = sigmoid(margin)
(``LogisticRegressionModelServable.java:62``). Labels must be {0, 1}.
"""
from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.linear import LinearEstimatorBase, LinearModelBase
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
from flink_ml_tpu_torch.params.shared import HasMultiClass, HasRawPredictionCol
from flink_ml_tpu_torch.servable.lib import LogisticRegressionModelServable, logistic_predict

__all__ = ["LogisticRegression", "LogisticRegressionModel"]


class LogisticRegressionModel(LinearModelBase, HasRawPredictionCol, HasMultiClass):
    """LogisticRegressionModel.java: dense and sparse ``transform``, save and load."""

    @classmethod
    def load_servable(cls, path: str):
        """The runtime-free servable of this model's save directory."""
        return LogisticRegressionModelServable.load_servable(path)

    def transform(self, *inputs, device=None):
        """Predictions on ``device`` (None → the GPU). A SparseVector
        features column stays in the padded layout: its margins come from
        ``sparse_dot_fn`` on the packed triple, as in the servable."""
        (df,) = inputs
        out = df.clone()
        if len(df) == 0:
            out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, np.zeros(0))
            out.add_column(
                self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE), np.zeros((0, 2))
            )
            return out
        pred, raw = logistic_predict(
            df, self.get_features_col(), self.coefficient, resolve_device(device)
        )
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        out.add_column(
            self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE),
            raw.cpu().numpy().astype(np.float64),
        )
        return out


    def sparse_kernel_spec(self, known):
        """The sparse-convention head for the batch plan (JAX
        ``logistic_regression.py:83``): the servable's spec — ``transform``'s
        sparse path runs the same ``sparse_dot_fn`` body, so the fused chain
        and the per-stage ``transform`` agree bit for bit at every nnz cap —
        when the features column is known sparse at the coefficient's width,
        else None. The model has no dense spec, as in the JAX package."""
        if self.coefficient is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        servable = (LogisticRegressionModelServable()
                    .set_features_col(self.get_features_col())
                    .set_prediction_col(self.get_prediction_col())
                    .set_raw_prediction_col(self.get_raw_prediction_col()))
        servable.coefficient = self.coefficient
        return servable.sparse_kernel_spec(known)


class LogisticRegression(LinearEstimatorBase, HasRawPredictionCol, HasMultiClass):
    """LogisticRegression.java:106-115."""

    _LOSS = BinaryLogisticLoss.INSTANCE
    _MODEL_CLASS = LogisticRegressionModel

    def _validate_labels(self, labels: np.ndarray) -> None:
        uniques = np.unique(labels)
        if not np.all(np.isin(uniques, [0.0, 1.0])):
            raise ValueError(
                f"LogisticRegression requires binary labels in {{0, 1}}, got {uniques[:10]}"
            )
