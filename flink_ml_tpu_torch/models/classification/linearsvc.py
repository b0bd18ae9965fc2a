"""Linear support vector classifier — twin of
``flink_ml_tpu/models/classification/linearsvc.py``.

Fit = SGD with ``HingeLoss`` (``LinearSVC.java``); prediction = margin ≥
threshold, rawPrediction = [margin, −margin] (``LinearSVCModel.java:177-180``),
threshold 0.0 by default. Labels must be {0, 1}.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.linear import LinearEstimatorBase, LinearModelBase, compute_dots
from flink_ml_tpu_torch.ops.lossfunc import HingeLoss
from flink_ml_tpu_torch.params.param import FloatParam, WithParams
from flink_ml_tpu_torch.params.shared import HasRawPredictionCol

__all__ = ["HasThreshold", "LinearSVC", "LinearSVCModel"]


class HasThreshold(WithParams):
    """Ref LinearSVCModelParams.THRESHOLD."""

    THRESHOLD = FloatParam(
        "threshold",
        "Threshold in binary classification applied to the raw prediction.",
        0.0,
    )

    def get_threshold(self) -> float:
        return self.get(self.THRESHOLD)

    def set_threshold(self, value: float):
        return self.set(self.THRESHOLD, value)


class LinearSVCModel(LinearModelBase, HasRawPredictionCol, HasThreshold):
    """Margins by ``compute_dots`` (dense, or a sparse column kept packed);
    the threshold is rounded to float32 before the compare, as in the JAX
    package."""

    def transform(self, *inputs, device=None):
        """Predictions on ``device`` (None → the GPU)."""
        (df,) = inputs
        dots = compute_dots(df, self.get_features_col(), self.coefficient, resolve_device(device))
        pred = (dots >= torch.tensor(self.get_threshold(), dtype=torch.float32)).to(dots.dtype)
        raw = torch.stack([dots, -dots], dim=1)
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        out.add_column(
            self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE),
            raw.cpu().numpy().astype(np.float64),
        )
        return out


class LinearSVC(LinearEstimatorBase, HasRawPredictionCol, HasThreshold):
    """Ref LinearSVC.java."""

    _LOSS = HingeLoss.INSTANCE
    _MODEL_CLASS = LinearSVCModel

    def _validate_labels(self, labels: np.ndarray) -> None:
        uniques = np.unique(labels)
        if not np.all(np.isin(uniques, [0.0, 1.0])):
            raise ValueError(
                f"LinearSVC requires binary labels in {{0, 1}}, got {uniques[:10]}"
            )
