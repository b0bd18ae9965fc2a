"""IDF — twin of ``flink_ml_tpu/models/feature/idf.py``.

fit: the document frequency of each term dimension;
``idf[i] = log((numDocs + 1) / (df[i] + 1))``, and dimensions with
``df < minDocFreq`` get idf 0 (``IDF.java``). transform multiplies
term-frequency vectors by idf, elementwise (``IDFModel.java``). A fitted
``IDFModel`` is its own runtime-free servable, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.linalg.vectors import SparseVector, Vector
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.ops.kernels import idf_scale_fn, sparse_idf_scale_fn
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators, update_existing_params
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import packed_tensors
from flink_ml_tpu_torch.servable.sparse import rebuild_sparse_column, sparse_names

__all__ = ["IDF", "IDFModel"]


class _IDFParams(HasInputCol, HasOutputCol):
    MIN_DOC_FREQ = IntParam(
        "minDocFreq",
        "Minimum number of documents that a term should appear for filtering.",
        0,
        ParamValidators.gt_eq(0),
    )

    def get_min_doc_freq(self) -> int:
        return self.get(self.MIN_DOC_FREQ)

    def set_min_doc_freq(self, value: int):
        return self.set(self.MIN_DOC_FREQ, value)


class IDFModel(ModelArraysMixin, Model, _IDFParams):
    """IDFModel.java: ``idf`` (float64 [d]) with the ``doc_freq`` and
    ``num_docs`` it came from."""

    _MODEL_ARRAY_NAMES = ("idf", "doc_freq", "num_docs")

    def __init__(self):
        super().__init__()
        self.idf: Optional[np.ndarray] = None
        self.doc_freq: Optional[np.ndarray] = None
        self.num_docs: Optional[np.ndarray] = None

    @classmethod
    def load_servable(cls, path: str) -> "IDFModel":
        """The fitted model is its own servable: a saved one (by either
        package) loads as it is."""
        return cls.load(path)

    def transform(self, *inputs, device=None):
        """The scaled column on ``device`` (None → the GPU), float32 math
        read back as float64: a dense array column through ``idf_scale_fn``;
        a SparseVector column through ``sparse_idf_scale_fn`` on its packed
        triple, never densified, each row keeping its indices."""
        (df,) = inputs
        in_col, out_col = self.get_input_col(), self.get_output_col()
        col = df.column(in_col)
        out = df.clone()
        if len(df) == 0:
            out.add_column(out_col, DataTypes.vector(BasicType.DOUBLE), [])
            return out
        dev = resolve_device(device)
        idf32 = torch.from_numpy(np.asarray(self.idf, np.float32)).to(dev)
        if isinstance(col, np.ndarray):
            X = torch.from_numpy(np.ascontiguousarray(col, np.float32)).to(dev)
            vals = idf_scale_fn(X, idf32).cpu().numpy().astype(np.float64)
        elif df.is_sparse(in_col):
            values, ids, nnz = packed_tensors(df, in_col, int(idf32.shape[0]), dev)
            vals = rebuild_sparse_column(
                int(idf32.shape[0]),
                sparse_idf_scale_fn(values, ids, idf32).cpu().numpy(),
                ids.cpu().numpy(),
                nnz.cpu().numpy(),
            )
        else:  # a list of dense vectors: host math, as the JAX package does
            idf = np.asarray(self.idf)
            vals = [
                SparseVector(v.size(), v.indices, v.values * idf[v.indices])
                if isinstance(v, SparseVector)
                else np.asarray(v.to_array()) * idf
                for v in col
            ]
        out.add_column(out_col, DataTypes.vector(BasicType.DOUBLE), vals)
        return out

    def kernel_spec(self) -> KernelSpec:
        """idf scaling of a dense array column as an elementwise spec."""
        if self.idf is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        in_col, out_col = self.get_input_col(), self.get_output_col()

        def kernel_fn(model, cols):
            return {out_col: idf_scale_fn(cols[in_col], model["idf"])}

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={"idf": np.asarray(self.idf, np.float32)},
            kernel_fn=kernel_fn,
            input_kinds={in_col: "dense"},
            elementwise=True,  # per-term scaling: no accumulation
            fusion_op="idf",
        )

    def sparse_kernel_spec(self, known):
        """When the input column is known sparse at the idf's width: a
        per-slot gather-scale (``sparse_idf_scale_fn``), ids and nnz passing
        through, the output column sparse too. No accumulation, so the spec
        is elementwise. Otherwise None (the dense spec serves)."""
        if self.idf is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        in_col, out_col = self.get_input_col(), self.get_output_col()
        dim = int(len(self.idf))
        if known.get(in_col) != dim:
            return None
        in_v, in_i, in_z = sparse_names(in_col)
        out_v, out_i, out_z = sparse_names(out_col)

        def kernel_fn(model, cols):
            return {
                out_v: sparse_idf_scale_fn(cols[in_v], cols[in_i], model["idf"]),
                out_i: cols[in_i],
                out_z: cols[in_z],
            }

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={"idf": np.asarray(self.idf, np.float32)},
            kernel_fn=kernel_fn,
            input_kinds={in_col: "sparse"},
            sparse_outputs={out_col: dim},
            sparse_input_dims={in_col: dim},
            elementwise=True,  # per-slot gather + multiply: no accumulation
            fusion_op="sparse_idf",
        )


class IDF(Estimator, _IDFParams):
    """IDF.java: fit on the host in float64, as the JAX package does."""

    def fit(self, *inputs) -> IDFModel:
        (df,) = inputs
        col = df.column(self.get_input_col())
        if isinstance(col, np.ndarray):
            docs = col.astype(np.float64)
            doc_freq = (docs != 0).sum(axis=0).astype(np.float64)
            num_docs = docs.shape[0]
        else:
            dim = col[0].size() if isinstance(col[0], Vector) else len(col[0])
            # a row's indices are unique (SparseVector's invariant), so one
            # bincount over every row's nonzero entries counts documents
            parts = [
                v.indices[v.values != 0] if isinstance(v, SparseVector)
                else np.flatnonzero(np.asarray(v.to_array()) != 0)
                for v in col
            ]
            doc_freq = np.bincount(
                np.concatenate(parts) if parts else np.zeros(0, np.int64), minlength=dim
            ).astype(np.float64)
            num_docs = len(col)
        idf = np.where(
            doc_freq >= self.get_min_doc_freq(),
            np.log((num_docs + 1.0) / (doc_freq + 1.0)),
            0.0,
        )
        model = IDFModel()
        update_existing_params(model, self)
        model.idf = idf
        model.doc_freq = doc_freq
        model.num_docs = np.asarray([num_docs])
        return model
