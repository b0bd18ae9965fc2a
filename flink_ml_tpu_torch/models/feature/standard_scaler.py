"""StandardScaler (batch) — twin of the batch half of
``flink_ml_tpu/models/feature/standard_scaler.py``.

fit: the masked column statistics on the device in float32 — the mean, and
the *centered* second moment Σ mask·(x − mean)², so |mean| ≫ std does not
cancel — finalized on the host in float64 as std = sqrt(Σ/(n − 1)), 0 when
n == 1 (``StandardScaler.java``). transform subtracts the mean if withMean
and multiplies by 1/std (0 for a zero std) if withStd
(``StandardScalerModel.java:60-97``), through the same servable math the
serving path runs. The Online* classes are not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.params.param import BoolParam, update_existing_params
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import StandardScalerModelServable

__all__ = ["StandardScaler", "StandardScalerModel"]


class _ScalerParams(HasInputCol, HasOutputCol):
    """StandardScalerParams — withMean (false), withStd (true)."""

    WITH_MEAN = BoolParam("withMean", "Whether centers the data with mean before scaling.", False)
    WITH_STD = BoolParam("withStd", "Whether scales the data with standard deviation.", True)

    def get_with_mean(self) -> bool:
        return self.get(self.WITH_MEAN)

    def set_with_mean(self, value: bool):
        return self.set(self.WITH_MEAN, value)

    def get_with_std(self) -> bool:
        return self.get(self.WITH_STD)

    def set_with_std(self, value: bool):
        return self.set(self.WITH_STD, value)


def _mean_std(sum_: np.ndarray, sq_sum: np.ndarray, n: float):
    """mean/std from [sum, squaredSum, count] (BuildModelOperator.endInput):
    std = sqrt((sqSum − n·mean²)/(n − 1)), 0 when n == 1."""
    mean = sum_ / n
    if n > 1:
        var = (sq_sum - n * mean * mean) / (n - 1)
        std = np.sqrt(np.maximum(var, 0.0))
    else:
        std = np.zeros_like(mean)
    return mean, std


def _stats(X: torch.Tensor, mask: torch.Tensor):
    """Masked mean, centered second moment and row count, float32."""
    n = torch.sum(mask)
    mean = torch.sum(X * mask[:, None], dim=0) / torch.clamp(n, min=1.0)
    c = (X - mean[None, :]) * mask[:, None]
    return mean, torch.sum(c * c, dim=0), n


class StandardScalerModel(ModelArraysMixin, Model, _ScalerParams):
    """StandardScalerModel.java: ``mean`` and ``std`` (float64 [d])."""

    _MODEL_ARRAY_NAMES = ("mean", "std")

    def __init__(self):
        super().__init__()
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    @classmethod
    def load_servable(cls, path: str) -> StandardScalerModelServable:
        """The runtime-free servable of this model's save directory."""
        return StandardScalerModelServable.load_servable(path)

    def _servable(self) -> StandardScalerModelServable:
        if self.mean is None:
            raise RuntimeError("model must be fit/loaded before transform or kernel_spec")
        servable = StandardScalerModelServable()
        update_existing_params(servable, self)
        servable.mean, servable.std = self.mean, self.std
        return servable

    def transform(self, *inputs, device=None):
        """The scaled column on ``device`` (None → the GPU): the servable's
        float32 math, read back as float64."""
        (df,) = inputs
        return self._servable().transform(df, device=device)

    def kernel_spec(self) -> KernelSpec:
        """Standardization as a fusable spec — the servable's."""
        return self._servable().kernel_spec()


class StandardScaler(Estimator, _ScalerParams):
    """StandardScaler.java."""

    def fit(self, *inputs, device=None) -> StandardScalerModel:
        """The column statistics on ``device`` (None → the GPU)."""
        (df,) = inputs
        if len(df) == 0:
            raise RuntimeError("The training set is empty.")
        dev = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(df.vectors(self.get_input_col()), np.float32)).to(dev)
        # One device holds every row: the mask is all ones (the JAX cache
        # pads shards to equal length and masks the padding out).
        mean, sq_c, n = _stats(X, torch.ones(X.shape[0], dtype=torch.float32, device=dev))
        mean = mean.cpu().numpy().astype(np.float64)
        n = float(n)
        if n > 1:
            std = np.sqrt(np.maximum(sq_c.cpu().numpy().astype(np.float64) / (n - 1), 0.0))
        else:
            std = np.zeros_like(mean)
        model = StandardScalerModel()
        update_existing_params(model, self)
        model.mean, model.std = mean, std
        return model
