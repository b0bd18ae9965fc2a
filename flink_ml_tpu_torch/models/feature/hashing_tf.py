"""HashingTF — twin of ``flink_ml_tpu/models/feature/hashing_tf.py``.

``HashingTF.java``: a list of terms becomes a sparse term-frequency vector of
``numFeatures`` dimensions by the hashing trick, index =
nonNegativeMod(murmur3_32(0)(term)) (``HashingTF.java:137-138, 161-193``);
counts, or 1s when ``binary``. The terms hash on the host
(``ops/hashing.py``); the counting is the device ``sparse_combine_fn`` on
both the per-stage path and the fused spec.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops import hashing
from flink_ml_tpu_torch.ops.kernels import sparse_combine_fn
from flink_ml_tpu_torch.params.param import BoolParam
from flink_ml_tpu_torch.params.shared import HasInputCol, HasNumFeatures, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import entry_tensors
from flink_ml_tpu_torch.servable.sparse import (
    entries_names,
    pack_entry_rows,
    rebuild_sparse_column,
    sparse_names,
)

__all__ = ["HashingTF"]


def _hash(obj) -> int:
    """HashingTF.hash:161 — guava murmur3_32(0) by the term's type."""
    if obj is None:
        return 0
    if isinstance(obj, (bool, np.bool_)):
        return hashing.hash_int(1 if obj else 0)
    if isinstance(obj, (int, np.integer)):
        v = int(obj)
        if -(1 << 31) <= v < (1 << 31):
            return hashing.hash_int(v)
        return hashing.hash_long(v)
    if isinstance(obj, (float, np.floating)):
        return hashing.hash_long(
            int.from_bytes(np.float64(obj).tobytes(), "little", signed=False)
        )
    if isinstance(obj, str):
        return hashing.hash_unencoded_chars(obj)
    raise TypeError(f"HashingTF does not support type {type(obj).__name__} of input data.")


class HashingTF(Transformer, HasInputCol, HasOutputCol, HasNumFeatures):
    """HashingTF.java."""

    BINARY = BoolParam(
        "binary", "Whether each dimension of the output vector is binary or not.", False
    )

    def get_binary(self) -> bool:
        return self.get(self.BINARY)

    def set_binary(self, value: bool):
        return self.set(self.BINARY, value)

    def _featurize(self, col):
        """The host half: each row's terms hashed to raw ``(index, 1.0)``
        entries, duplicates kept for the device combine. Shared by
        ``transform`` and the spec's host ingest, so both hash alike. A
        string's index is computed once a call (strings are the only terms
        whose equal values always hash alike: ``0.0 == -0.0``, ``1 == 1.0``)."""
        num_features = self.get_num_features()
        seen = {}
        rows = []
        lengths = []
        for terms in col:
            row = []
            for term in terms:
                if type(term) is str:
                    idx = seen.get(term)
                    if idx is None:
                        idx = seen[term] = hashing.non_negative_mod(_hash(term), num_features)
                else:
                    idx = hashing.non_negative_mod(_hash(term), num_features)
                row.append((idx, 1.0))
            rows.append(row)
            lengths.append(len(terms))
        return rows, lengths

    def transform(self, *inputs, device=None):
        """Term frequencies on ``device`` (None → the GPU): the terms hashed
        on the host, counted by ``sparse_combine_fn`` — the body the fused
        spec runs, so both paths give the same bits (counts are small
        integers, exact in float32)."""
        (df,) = inputs
        dev = resolve_device(device)
        num_features = self.get_num_features()
        out_col = self.get_output_col()
        rows, lengths = self._featurize(df.column(self.get_input_col()))
        values, ids, nnz, _len = entry_tensors(out_col, rows, lengths, dev)
        values, ids, nnz = sparse_combine_fn(values, ids, nnz)
        if self.get_binary():
            values = torch.clamp(values, max=1.0)
        vectors = rebuild_sparse_column(
            num_features, values.cpu().numpy(), ids.cpu().numpy(), nnz.cpu().numpy()
        )
        out = df.clone()
        out.add_column(out_col, DataTypes.vector(BasicType.DOUBLE), vectors)
        return out

    def sparse_kernel_spec(self, known):
        """The spec of the sparse convention: the tokens column featurizes
        on the host (``_featurize``) into raw entries at a ladder cap, the
        device kernel is ``sparse_combine_fn``, and the output is sparse, so
        IDF and the logistic head chain on without SparseVectors between."""
        num_features = self.get_num_features()
        binary = self.get_binary()
        in_col, out_col = self.get_input_col(), self.get_output_col()
        vn, idn, zn, _ln = entries_names(in_col)
        out_v, out_i, out_z = sparse_names(out_col)

        def host_ingest(df, cap, cap_max, truncate):
            rows, lengths = self._featurize(df.column(in_col))
            return pack_entry_rows(in_col, rows, lengths, cap=cap, cap_max=cap_max, truncate=truncate)

        def kernel_fn(model, cols):
            values, ids, nnz = sparse_combine_fn(cols[vn], cols[idn], cols[zn])
            if binary:
                values = torch.clamp(values, max=1.0)
            return {out_v: values, out_i: ids, out_z: nnz}

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={},
            kernel_fn=kernel_fn,
            input_kinds={in_col: "entries"},
            host_ingests={in_col: host_ingest},
            sparse_outputs={out_col: int(num_features)},
        )
