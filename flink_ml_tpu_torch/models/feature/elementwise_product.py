"""ElementwiseProduct — twin of ``flink_ml_tpu/models/feature/elementwise_product.py``.

The Hadamard product of each input vector with ``scalingVec``
(``ElementwiseProduct.java``): a dense array column through
``elementwise_product_fn`` (``ops/kernels.py``); SparseVectors stay sparse
on the host, as in the JAX package. A stateless Transformer is its own
servable.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.linalg.vectors import SparseVector, Vector
from flink_ml_tpu_torch.ops.kernels import elementwise_product_fn
from flink_ml_tpu_torch.params.param import ParamValidators, VectorParam
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec

__all__ = ["ElementwiseProduct"]


class ElementwiseProduct(Transformer, HasInputCol, HasOutputCol):
    """ElementwiseProduct.java."""

    SCALING_VEC = VectorParam(
        "scalingVec",
        "The scaling vector to multiply with input vectors using hadamard product.",
        None,
        ParamValidators.not_null(),
    )

    def get_scaling_vec(self):
        return self.get(self.SCALING_VEC)

    def set_scaling_vec(self, value):
        return self.set(self.SCALING_VEC, value)

    def _scaling_array(self) -> np.ndarray:
        scaling = self.get_scaling_vec()
        return scaling.to_array() if isinstance(scaling, Vector) else np.asarray(scaling)

    def transform(self, *inputs, device=None):
        """The product column: a dense array column on ``device`` (None →
        the GPU) in float32, read back as float64; a list column on the
        host in float64, SparseVectors keeping their indices."""
        (df,) = inputs
        s = self._scaling_array()
        col = df.column(self.get_input_col())
        out = df.clone()
        if isinstance(col, np.ndarray):
            dev = resolve_device(device)
            X = torch.from_numpy(np.ascontiguousarray(col, np.float32)).to(dev)
            scaling = torch.from_numpy(np.ascontiguousarray(s, np.float32)).to(dev)
            vals = elementwise_product_fn(X, scaling).cpu().numpy().astype(np.float64)
        else:
            vals = [
                SparseVector(v.size(), v.indices, v.values * s[v.indices])
                if isinstance(v, SparseVector)
                else v.to_array() * s
                for v in col
            ]
        out.add_column(self.get_output_col(), DataTypes.vector(BasicType.DOUBLE), vals)
        return out

    def kernel_spec(self):
        """The Hadamard product as a fusable spec with the scaling vector as
        a float32 device tensor. The column ingests as ``dense``: a list
        (sparse) column falls back to ``transform``."""
        if self.get_scaling_vec() is None:
            return None
        in_col, out_col = self.get_input_col(), self.get_output_col()

        def kernel_fn(model, cols):
            return {out_col: elementwise_product_fn(cols[in_col], model["scaling"])}

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={"scaling": np.asarray(self._scaling_array(), np.float32)},
            kernel_fn=kernel_fn,
            input_kinds={in_col: "dense"},
            elementwise=True,  # Hadamard product: no accumulation
            fusion_op="elementwise_product",
        )
