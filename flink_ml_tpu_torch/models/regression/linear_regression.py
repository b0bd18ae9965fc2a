"""Linear regression — twin of
``flink_ml_tpu/models/regression/linear_regression.py``.

Fit = SGD with ``LeastSquareLoss`` (``LinearRegression.java``); prediction =
the margin itself (``LinearRegressionModel.java``).
"""
from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.linear import LinearEstimatorBase, LinearModelBase, compute_dots
from flink_ml_tpu_torch.ops.lossfunc import LeastSquareLoss

__all__ = ["LinearRegression", "LinearRegressionModel"]


class LinearRegressionModel(LinearModelBase):
    """Prediction = the margin, from ``compute_dots`` (dense or sparse)."""

    def transform(self, *inputs, device=None):
        """Predictions on ``device`` (None → the GPU)."""
        (df,) = inputs
        pred = compute_dots(df, self.get_features_col(), self.coefficient, resolve_device(device))
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        return out


class LinearRegression(LinearEstimatorBase):
    """Ref LinearRegression.java."""

    _LOSS = LeastSquareLoss.INSTANCE
    _MODEL_CLASS = LinearRegressionModel
