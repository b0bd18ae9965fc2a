"""Columnar in-memory DataFrame — twin of ``flink_ml_tpu/api/dataframe.py``.

Columns stay on the host as numpy arrays ([n] scalars, [n, d] dense vectors)
or Python lists for ragged data (sparse vectors, strings), exactly as in the
JAX package, so DataFrames from the two packages compare column by column.
The serving plan moves a column to the device as one tensor at ingest and
reads outputs back into numpy at finalize.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from flink_ml_tpu_torch.api.types import BasicType, DataType, DataTypes
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector, Vector

__all__ = ["DataFrame"]

Column = Union[np.ndarray, list]


def _column_length(col: Column) -> int:
    return int(col.shape[0]) if isinstance(col, np.ndarray) else len(col)


def _infer_type(col: Column) -> DataType:
    if isinstance(col, np.ndarray):
        if col.ndim == 2:
            return DataTypes.vector(BasicType.DOUBLE)
        if np.issubdtype(col.dtype, np.bool_):
            return DataTypes.BOOLEAN
        if np.issubdtype(col.dtype, np.integer):
            return DataTypes.LONG
        if np.issubdtype(col.dtype, np.floating):
            return DataTypes.DOUBLE
        return DataTypes.STRING
    for v in col:
        if v is None:
            continue
        if isinstance(v, Vector):
            return DataTypes.vector(BasicType.DOUBLE)
        if isinstance(v, bool):
            return DataTypes.BOOLEAN
        if isinstance(v, (int, np.integer)):
            return DataTypes.LONG
        if isinstance(v, (float, np.floating)):
            return DataTypes.DOUBLE
        if isinstance(v, str):
            return DataTypes.STRING
        break
    return DataTypes.STRING


def _normalize_column(col: Any) -> Column:
    """Canonicalize user input into a numpy array (dense/scalars) or list (ragged)."""
    if isinstance(col, np.ndarray):
        return col
    col = list(col)
    if col and isinstance(col[0], (list, tuple)):
        # Numeric lists of equal length densify to a [n, d] array; true ragged
        # data stays a Python list.
        try:
            arr = np.asarray(col)
            if arr.dtype.kind in "biufc" and arr.ndim == 2:
                return arr
        except (ValueError, TypeError):
            pass
        return col
    if col and isinstance(col[0], DenseVector):
        dims = {v.size() for v in col if v is not None}
        if len(dims) == 1 and not any(v is None for v in col):
            return np.stack([v.values for v in col])
        return col
    if col and isinstance(col[0], (SparseVector, str)) or any(v is None for v in col):
        return col
    try:
        arr = np.asarray(col)
        if arr.dtype != object:
            return arr
    except (ValueError, TypeError):
        pass  # ragged / mixed content stays a Python list
    return col


class DataFrame:
    """Columnar table. A DataFrame is a request/response value: it crosses
    threads only through the batcher's queue and its per-request ``Event``,
    and no two threads mutate one instance at once."""

    def __init__(
        self,
        column_names: Sequence[str],
        data_types: Optional[Sequence[DataType]] = None,
        columns: Sequence[Column] = (),
    ):
        self._names: List[str] = list(column_names)
        self._columns: List[Column] = [_normalize_column(c) for c in columns]
        if len(self._names) != len(self._columns):
            raise ValueError(
                f"{len(self._names)} column names but {len(self._columns)} columns"
            )
        if data_types is None:
            data_types = [_infer_type(c) for c in self._columns]
        self._types: List[DataType] = list(data_types)
        lengths = {_column_length(c) for c in self._columns}
        if len(lengths) > 1:
            raise ValueError(f"Columns have inconsistent lengths: {lengths}")

    # --- construction --------------------------------------------------------
    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "DataFrame":
        names = list(data.keys())
        return DataFrame(names, None, [data[n] for n in names])

    @staticmethod
    def concat(frames: Sequence["DataFrame"]) -> "DataFrame":
        """Row-concatenate DataFrames with identical schemas (types from the
        first frame) — the micro-batcher's coalescing primitive."""
        if not frames:
            raise ValueError("concat of zero DataFrames")
        first = frames[0]
        if len(frames) == 1:
            return first.clone()
        names = first.get_column_names()
        for f in frames[1:]:
            if f.get_column_names() != names:
                raise ValueError(
                    f"schema mismatch in concat: {f.get_column_names()} != {names}"
                )
        cols: List[Column] = []
        for name in names:
            parts = [f.column(name) for f in frames]
            if all(isinstance(p, np.ndarray) for p in parts):
                cols.append(np.concatenate(parts))
            else:
                merged: list = []
                for p in parts:
                    merged.extend(p if isinstance(p, list) else list(p))
                cols.append(merged)
        return DataFrame(names, first.get_data_types(), cols)

    # --- schema --------------------------------------------------------------
    def get_column_names(self) -> List[str]:
        return list(self._names)

    def get_data_types(self) -> List[DataType]:
        return list(self._types)

    def get_index(self, name: str) -> int:
        return self._names.index(name)

    @property
    def num_rows(self) -> int:
        return _column_length(self._columns[0]) if self._columns else 0

    def __len__(self) -> int:
        return self.num_rows

    # --- column access -------------------------------------------------------
    def column(self, name: str) -> Column:
        return self._columns[self.get_index(name)]

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    def vectors(self, name: str) -> np.ndarray:
        """Column as a dense [n, d] array (scalars widen to [n, 1], lists of
        vectors stack, sparse vectors densify)."""
        col = self.column(name)
        if isinstance(col, np.ndarray):
            if col.ndim == 1:
                return col.astype(np.float64)[:, None]
            return col
        return np.stack([v.to_array() if isinstance(v, Vector) else np.asarray(v) for v in col])

    def is_sparse(self, name: str) -> bool:
        """Whether the column holds SparseVectors (the wide-features layout)."""
        col = self.column(name)
        return isinstance(col, list) and bool(col) and isinstance(col[0], SparseVector)

    def sparse_batch(self, name: str):
        """Column as a padded-CSR ``SparseBatch`` (``linalg/sparse_batch.py``);
        a mixed column's DenseVectors are converted row-wise."""
        from flink_ml_tpu_torch.linalg.sparse_batch import SparseBatch

        col = self.column(name)
        if not (isinstance(col, list) and col and all(isinstance(v, Vector) for v in col)):
            raise TypeError(f"column {name!r} is not a vector column")
        return SparseBatch.from_vectors([v.to_sparse() for v in col])

    def scalars(self, name: str, dtype=np.float64) -> np.ndarray:
        """Column as a [n] array of ``dtype``."""
        return np.asarray(self.column(name), dtype=dtype)

    # --- mutation-style API (returns self) -----------------------------------
    def add_column(self, name: str, data_type: DataType, values: Column) -> "DataFrame":
        values = _normalize_column(values)
        if self._columns and _column_length(values) != self.num_rows:
            raise ValueError(
                f"Column {name} has {_column_length(values)} rows, expected {self.num_rows}"
            )
        if name in self._names:
            idx = self.get_index(name)
            self._columns[idx] = values
            self._types[idx] = data_type
        else:
            self._names.append(name)
            self._types.append(data_type)
            self._columns.append(values)
        return self

    def take(self, indices) -> "DataFrame":
        """Row subset / reorder by integer indices or a boolean mask."""
        indices = np.asarray(indices)
        if indices.dtype == np.bool_:
            if indices.size != self.num_rows:
                raise IndexError(
                    f"boolean mask has {indices.size} entries for {self.num_rows} rows"
                )
            indices = np.flatnonzero(indices)
        else:
            indices = indices.astype(np.int64)
        cols = [
            c[indices] if isinstance(c, np.ndarray) else [c[int(i)] for i in indices]
            for c in self._columns
        ]
        return DataFrame(list(self._names), list(self._types), cols)

    def clone(self) -> "DataFrame":
        return DataFrame(list(self._names), list(self._types), list(self._columns))

    def __repr__(self) -> str:
        return f"DataFrame(columns={self._names}, num_rows={self.num_rows})"
