"""Columnar in-memory DataFrame — twin of ``flink_ml_tpu/api/dataframe.py``.

Columns stay on the host as numpy arrays ([n] scalars, [n, d] dense vectors)
or Python lists for ragged data (sparse vectors, strings), exactly as in the
JAX package, so DataFrames from the two packages compare column by column.
The serving plan moves a column to the device as one tensor at ingest and
reads outputs back into numpy at finalize. The row-oriented API (``Row``,
``from_rows``, ``collect``) is kept at the boundary, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from flink_ml_tpu_torch.api.types import BasicType, DataType, DataTypes
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector, Vector

__all__ = ["DataFrame", "Row"]

Column = Union[np.ndarray, list]


class Row:
    """A row of values (servable/api/Row.java)."""

    __slots__ = ("values",)

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def get(self, index: int) -> Any:
        return self.values[index]

    def size(self) -> int:
        return len(self.values)

    def __getitem__(self, index: int) -> Any:
        return self.values[index]

    def __len__(self) -> int:
        return len(self.values)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Row) or len(other) != len(self):
            return False
        for a, b in zip(self.values, other.values):
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                if not np.array_equal(a, b):
                    return False
            elif a != b:
                return False
        return True

    def __repr__(self) -> str:
        return f"Row({self.values!r})"


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
    def from_rows(
        column_names: Sequence[str],
        rows: Iterable[Union[Row, Sequence[Any]]],
        data_types: Optional[Sequence[DataType]] = None,
    ) -> "DataFrame":
        rows = [r.values if isinstance(r, Row) else list(r) for r in rows]
        cols = (
            [_normalize_column([r[i] for r in rows]) for i in range(len(column_names))]
            if rows
            else [[] for _ in column_names]
        )
        return DataFrame(column_names, data_types, cols)

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

    @property
    def column_names(self) -> List[str]:
        return list(self._names)

    def get_data_types(self) -> List[DataType]:
        return list(self._types)

    def get_index(self, name: str) -> int:
        return self._names.index(name)

    def get_data_type(self, name: str) -> DataType:
        return self._types[self.get_index(name)]

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

    def with_column(self, name: str, values: Column, data_type: Optional[DataType] = None) -> "DataFrame":
        """A new DataFrame with the column added or replaced (type inferred
        when not given); this one is left as it is."""
        values = _normalize_column(values)
        if data_type is None:
            data_type = _infer_type(values)
        out = self.clone()
        out.add_column(name, data_type, values)
        return out

    def select(self, names: Sequence[str]) -> "DataFrame":
        idxs = [self.get_index(n) for n in names]
        return DataFrame(
            [self._names[i] for i in idxs],
            [self._types[i] for i in idxs],
            [self._columns[i] for i in idxs],
        )

    def drop(self, *names: str) -> "DataFrame":
        return self.select([n for n in self._names if n not in names])

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

    # --- row boundary --------------------------------------------------------
    @staticmethod
    def _cell(col: Column, i: int) -> Any:
        if isinstance(col, np.ndarray):
            if col.ndim == 2:
                return DenseVector(col[i])
            v = col[i]
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, np.bool_):
                return bool(v)
            return v
        return col[i]

    def collect(self) -> List[Row]:
        """The rows, each cell as a Python value or a vector (DataFrame.collect)."""
        return [Row([self._cell(c, i) for c in self._columns]) for i in range(self.num_rows)]

    def __repr__(self) -> str:
        return f"DataFrame(columns={self._names}, num_rows={self.num_rows})"
