"""FeatureHasher — twin of ``flink_ml_tpu/models/feature/feature_hasher.py``.

``FeatureHasher.java``: numeric and categorical columns projected into a
``numFeatures``-wide sparse vector. A numeric column goes to index
hash(colName) with value x, a categorical one to hash("col=value") with
value 1.0, index = Math.abs(murmur3_32(0).hashUnencodedChars(s)) %
numFeatures (``FeatureHasher.java:185-190``); colliding contributions add
up. The rows hash on the host; the adding up is the device
``sparse_combine_fn``, in column order.
"""
from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops import hashing
from flink_ml_tpu_torch.ops.kernels import sparse_combine_fn
from flink_ml_tpu_torch.params.shared import (
    HasCategoricalCols,
    HasInputCols,
    HasNumFeatures,
    HasOutputCol,
)
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import entry_tensors
from flink_ml_tpu_torch.servable.sparse import (
    entries_names,
    pack_entry_rows,
    rebuild_sparse_column,
    sparse_names,
)

__all__ = ["FeatureHasher"]


def _index(s: str, num_features: int) -> int:
    return hashing.java_abs(hashing.hash_unencoded_chars(s)) % num_features


class FeatureHasher(Transformer, HasInputCols, HasOutputCol, HasCategoricalCols, HasNumFeatures):
    """FeatureHasher.java."""

    def _featurize(self, df):
        """The host half: each row's contributions as raw ``(index, value)``
        entries in column order (the reference's order of accumulation),
        numeric columns first at their hash(colName) index with value x,
        then categorical ones at hash("col=value") with value 1.0;
        collisions kept for the device combine. Shared by ``transform`` and
        the spec's host ingest."""
        num_features = self.get_num_features()
        in_cols = list(self.get_input_cols())
        cat_cols = list(self.get_categorical_cols())
        if cat_cols and not set(cat_cols) <= set(in_cols):
            raise ValueError("CategoricalCols must be included in inputCols!")
        # an undeclared column that is not numeric is categorical, as the
        # reference's schema inspection decides (generateCategoricalCols)
        num_cols = []
        for name in in_cols:
            if name in cat_cols:
                continue
            col = df.column(name)
            if isinstance(col, np.ndarray) and np.issubdtype(col.dtype, np.number):
                num_cols.append(name)
            else:
                cat_cols.append(name)
        columns = {name: df.column(name) for name in in_cols}
        num_idx = {name: _index(name, num_features) for name in num_cols}
        rows = []
        for i in range(len(df)):
            entries = []
            for name in num_cols:
                v = columns[name][i]
                if v is not None:
                    entries.append((num_idx[name], float(v)))
            for name in cat_cols:
                v = columns[name][i]
                if v is None:
                    continue
                if isinstance(v, (bool, np.bool_)):
                    v = "true" if v else "false"  # Java String.valueOf(boolean)
                entries.append((_index(f"{name}={v}", num_features), 1.0))
            rows.append(entries)
        return rows, [len(r) for r in rows]

    def transform(self, *inputs, device=None):
        """The hashed vectors on ``device`` (None → the GPU): the rows
        hashed on the host, the collisions added by ``sparse_combine_fn``
        in slot order — the body the fused spec runs."""
        (df,) = inputs
        dev = resolve_device(device)
        out_col = self.get_output_col()
        rows, lengths = self._featurize(df)
        values, ids, nnz, _len = entry_tensors(out_col, rows, lengths, dev)
        values, ids, nnz = sparse_combine_fn(values, ids, nnz)
        vectors = rebuild_sparse_column(
            self.get_num_features(), values.cpu().numpy(), ids.cpu().numpy(), nnz.cpu().numpy()
        )
        out = df.clone()
        out.add_column(out_col, DataTypes.vector(BasicType.DOUBLE), vectors)
        return out

    def sparse_kernel_spec(self, known):
        """The spec of the sparse convention: the whole row hashes on the
        host into raw entries under a synthetic source column (the ingest
        reads the DataFrame itself), the device kernel is
        ``sparse_combine_fn``, and the output is sparse."""
        num_features = self.get_num_features()
        out_col = self.get_output_col()
        src = f"{out_col}!src"
        vn, idn, zn, _ln = entries_names(src)
        out_v, out_i, out_z = sparse_names(out_col)

        def host_ingest(df, cap, cap_max, truncate):
            rows, lengths = self._featurize(df)
            return pack_entry_rows(src, rows, lengths, cap=cap, cap_max=cap_max, truncate=truncate)

        def kernel_fn(model, cols):
            values, ids, nnz = sparse_combine_fn(cols[vn], cols[idn], cols[zn])
            return {out_v: values, out_i: ids, out_z: nnz}

        return KernelSpec(
            input_cols=(src,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={},
            kernel_fn=kernel_fn,
            input_kinds={src: "entries"},
            host_ingests={src: host_ingest},
            sparse_outputs={out_col: int(num_features)},
        )
