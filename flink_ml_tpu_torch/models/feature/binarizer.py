"""Binarizer — twin of ``flink_ml_tpu/models/feature/binarizer.py``.

Per input column i, values > thresholds[i] become 1.0, others 0.0
(``Binarizer.java``), on scalar and vector columns. A numeric array column
runs ``binarize_fn`` (``ops/kernels.py``) in float32 on the device; a float
column comes back in its own dtype, any other as float32, as in the JAX
package. List columns (SparseVectors) stay on the host and keep their
sparsity. A stateless Transformer is its own servable.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.linalg.vectors import SparseVector, Vector
from flink_ml_tpu_torch.ops.kernels import binarize_fn
from flink_ml_tpu_torch.params.param import FloatArrayParam, ParamValidators
from flink_ml_tpu_torch.params.shared import HasInputCols, HasOutputCols
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec

__all__ = ["Binarizer"]


class Binarizer(Transformer, HasInputCols, HasOutputCols):
    """Binarizer.java."""

    THRESHOLDS = FloatArrayParam(
        "thresholds",
        "The thresholds used to binarize continuous features; one per input column.",
        None,
        ParamValidators.non_empty_array(),
    )

    def get_thresholds(self):
        return self.get(self.THRESHOLDS)

    def set_thresholds(self, *values: float):
        return self.set(self.THRESHOLDS, list(values))

    def transform(self, *inputs, device=None):
        (df,) = inputs
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        thresholds = self.get_thresholds()
        if len(in_cols) != len(thresholds):
            raise ValueError("Binarizer: number of thresholds must match number of input columns")
        out = df.clone()
        for name, out_name, thr in zip(in_cols, out_cols, thresholds):
            col = df.column(name)
            if isinstance(col, np.ndarray):
                # float16 stays float16 and everything else becomes float32:
                # the dtypes JAX computes in
                dt = np.float16 if col.dtype == np.float16 else np.float32
                x = torch.from_numpy(np.ascontiguousarray(col, dt)).to(resolve_device(device))
                vals = binarize_fn(x, float(thr)).cpu().numpy()
                if col.dtype.kind == "f":
                    vals = vals.astype(col.dtype, copy=False)
                dtype = DataTypes.vector(BasicType.DOUBLE) if vals.ndim == 2 else DataTypes.DOUBLE
                out.add_column(out_name, dtype, vals)
            else:  # ragged (sparse vectors): binarize stored values, keep sparsity
                new_col = []
                for v in col:
                    if isinstance(v, SparseVector):
                        kept = v.values > thr
                        new_col.append(SparseVector(v.size(), v.indices[kept], np.ones(kept.sum())))
                    elif isinstance(v, Vector):
                        new_col.append((v.to_array() > thr).astype(np.float64))
                    else:
                        new_col.append(1.0 if v > thr else 0.0)
                out.add_column(out_name, DataTypes.vector(BasicType.DOUBLE), new_col)
        return out

    def kernel_spec(self):
        """Per-column thresholding as a fusable spec — ``binarize_fn``, the
        thresholds in ``fusion_params`` for the CUDA megakernel. Columns
        ingest as ``dense`` (a list column falls back to ``transform``);
        outputs take their DataType from their shape at readback. None when
        the params disagree: ``transform`` raises the param error."""
        in_cols, out_cols = self.get_input_cols(), self.get_output_cols()
        thresholds = self.get_thresholds()
        if not in_cols or thresholds is None or len(in_cols) != len(thresholds):
            return None
        bindings = tuple(zip(in_cols, out_cols, [float(t) for t in thresholds]))

        def kernel_fn(model, cols):
            return {o: binarize_fn(cols[n], t) for n, o, t in bindings}

        return KernelSpec(
            input_cols=in_cols,
            outputs=tuple((o, None) for o in out_cols),
            model_arrays={},
            kernel_fn=kernel_fn,
            input_kinds={n: "dense" for n in in_cols},
            elementwise=True,  # threshold compare: no accumulation
            fusion_op="binarize",
            fusion_params={"thresholds": tuple(t for _, _, t in bindings)},
        )
