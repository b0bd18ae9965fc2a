"""Normalizer — twin of ``flink_ml_tpu/models/feature/normalizer.py``.

Scales each vector to unit p-norm (p ≥ 1, default 2; ``Normalizer.java``)
through ``normalize_fn`` (``ops/kernels.py``), the body its kernel spec
serves. A stateless Transformer is its own servable.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops.kernels import normalize_fn
from flink_ml_tpu_torch.params.param import FloatParam, ParamValidators
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec

__all__ = ["Normalizer"]


class Normalizer(Transformer, HasInputCol, HasOutputCol):
    """Normalizer.java."""

    P = FloatParam("p", "The p norm value.", 2.0, ParamValidators.gt_eq(1.0))

    def get_p(self) -> float:
        return self.get(self.P)

    def set_p(self, value: float):
        return self.set(self.P, value)

    def transform(self, *inputs, device=None):
        """The normalized column on ``device`` (None → the GPU), float32
        math read back as float64."""
        (df,) = inputs
        X = torch.from_numpy(np.ascontiguousarray(df.vectors(self.get_input_col()), np.float32))
        vals = normalize_fn(X.to(resolve_device(device)), float(self.get_p()))
        out = df.clone()
        out.add_column(self.get_output_col(), DataTypes.vector(BasicType.DOUBLE),
                       vals.cpu().numpy().astype(np.float64))
        return out

    def kernel_spec(self) -> KernelSpec:
        """Row-wise unit p-norm scaling as a fusable spec — ``normalize_fn``;
        ``p`` rides in ``fusion_params`` for the CUDA megakernel."""
        in_col, out_col, p = self.get_input_col(), self.get_output_col(), float(self.get_p())

        def kernel_fn(model, cols):
            return {out_col: normalize_fn(cols[in_col], p)}

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={},
            kernel_fn=kernel_fn,
            fusion_op="normalize",
            fusion_params={"p": p},
        )
