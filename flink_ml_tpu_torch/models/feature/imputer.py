"""Imputer — twin of ``flink_ml_tpu/models/feature/imputer.py``.

Multi-column completion of missing values (``missingValue``, default NaN)
with each column's mean, median or most frequent value over its
non-missing entries (``Imputer.java``). The fit runs on the host in
float64, as in the JAX package; ``ImputerModel.transform`` fills through
``impute_fn`` (``ops/kernels.py``), the body its kernel spec serves. A
fitted ImputerModel is its own servable, as IDFModel is.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.ops.kernels import impute_fn
from flink_ml_tpu_torch.params.param import FloatParam, ParamValidators, StringParam, update_existing_params
from flink_ml_tpu_torch.params.shared import HasInputCols, HasOutputCols, HasRelativeError
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec

__all__ = ["Imputer", "ImputerModel"]


class _ImputerParams(HasInputCols, HasOutputCols, HasRelativeError):
    MEAN, MEDIAN, MOST_FREQUENT = "mean", "median", "most_frequent"

    STRATEGY = StringParam(
        "strategy",
        "The imputation strategy.",
        "mean",
        ParamValidators.in_array(["mean", "median", "most_frequent"]),
    )
    MISSING_VALUE = FloatParam("missingValue", "The placeholder for the missing values.", float("nan"))

    def get_strategy(self) -> str:
        return self.get(self.STRATEGY)

    def set_strategy(self, value: str):
        return self.set(self.STRATEGY, value)

    def get_missing_value(self) -> float:
        return self.get(self.MISSING_VALUE)

    def set_missing_value(self, value: float):
        return self.set(self.MISSING_VALUE, value)


def _is_missing(x: np.ndarray, missing: float) -> np.ndarray:
    return np.isnan(x) if np.isnan(missing) else (x == missing)


def _missing_static(missing: float) -> Tuple[bool, float]:
    """The placeholder as ``(is_nan, value)``; a NaN one as ``(True, 0.0)``."""
    return (True, 0.0) if np.isnan(missing) else (False, float(missing))


class ImputerModel(ModelArraysMixin, Model, _ImputerParams):
    """ImputerModel.java: one surrogate per input column (``surrogates``)."""

    _MODEL_ARRAY_NAMES = ("surrogates",)

    def __init__(self):
        super().__init__()
        self.surrogates: Optional[np.ndarray] = None

    @classmethod
    def load_servable(cls, path: str) -> "ImputerModel":
        """The fitted model is its own servable: a saved one (by either
        package) loads as it is."""
        return cls.load(path)

    def transform(self, *inputs, device=None):
        """Each input column filled on ``device`` (None → the GPU) in float32,
        read back as a float64 scalar column."""
        (df,) = inputs
        if self.surrogates is None:
            raise RuntimeError("set_model_data must be called before transform")
        is_nan, value = _missing_static(self.get_missing_value())
        dev = resolve_device(device)
        surrogates = torch.from_numpy(np.asarray(self.surrogates, np.float32)).to(dev)
        out = df.clone()
        for i, (in_name, out_name) in enumerate(zip(self.get_input_cols(), self.get_output_cols())):
            x = torch.from_numpy(df.scalars(in_name, np.float32)).to(dev)
            filled = impute_fn(x, surrogates[i], is_nan, value)
            out.add_column(out_name, DataTypes.DOUBLE, filled.cpu().numpy().astype(np.float64))
        return out

    def kernel_spec(self) -> KernelSpec:
        """The per-column fill as a fusable spec — ``impute_fn`` with the
        surrogates as a float32 device tensor, one binding per column read
        as a ``scalar`` column; the placeholder rides in ``fusion_params``
        for the CUDA megakernel."""
        if self.surrogates is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        is_nan, value = _missing_static(self.get_missing_value())
        bindings = tuple((i, n, o) for i, (n, o) in enumerate(zip(in_cols, out_cols)))

        def kernel_fn(model, cols):
            return {o: impute_fn(cols[n], model["surrogates"][i], is_nan, value) for i, n, o in bindings}

        return KernelSpec(
            input_cols=in_cols,
            outputs=tuple((o, DataTypes.DOUBLE) for o in out_cols),
            model_arrays={"surrogates": np.asarray(self.surrogates, np.float32)},
            kernel_fn=kernel_fn,
            input_kinds={n: "scalar" for n in in_cols},
            elementwise=True,  # isnan/where fill: no accumulation
            fusion_op="impute",
            fusion_params={"missing_is_nan": is_nan, "missing_value": value},
        )


class Imputer(Estimator, _ImputerParams):
    """Imputer.java: the surrogates in float64 on the host, as the JAX
    package computes them."""

    def fit(self, *inputs) -> ImputerModel:
        (df,) = inputs
        strategy = self.get_strategy()
        missing = self.get_missing_value()
        surrogates = []
        for name in self.get_input_cols():
            x = df.scalars(name)
            valid = x[~_is_missing(x, missing) & ~np.isnan(x)]
            if valid.size == 0:
                raise RuntimeError(f"Imputer: column {name} has no valid values to fit.")
            if strategy == self.MEAN:
                surrogates.append(valid.mean())
            elif strategy == self.MEDIAN:
                surrogates.append(np.median(valid))
            else:  # most_frequent: the smallest of the modes
                vals, counts = np.unique(valid, return_counts=True)
                surrogates.append(vals[np.argmax(counts)])
        model = ImputerModel()
        update_existing_params(model, self)
        model.surrogates = np.asarray(surrogates)
        return model
