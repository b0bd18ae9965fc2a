"""Vector types mirroring the reference's linalg API, host-side.

Reference parity:
  - ``Vector``        <- flink-ml-servable-core/.../linalg/Vector.java
  - ``DenseVector``   <- DenseVector.java
  - ``SparseVector``  <- SparseVector.java (sorted indices + values invariant)
  - ``Vectors``       <- Vectors.java (factory methods)

These are *containers*, not compute objects: the compute path is columnar
(2-D arrays of shape [n, dim] for dense columns) so that a column reaches the
device as one tensor. Same classes and invariants as
``flink_ml_tpu/linalg/vectors.py``.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

__all__ = ["Vector", "DenseVector", "SparseVector", "Vectors"]


class Vector:
    """A vector of double values. Ref Vector.java."""

    def size(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> float:
        raise NotImplementedError

    def set(self, i: int, value: float) -> None:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError

    def to_dense(self) -> "DenseVector":
        raise NotImplementedError

    def to_sparse(self) -> "SparseVector":
        raise NotImplementedError

    def clone(self) -> "Vector":
        raise NotImplementedError

    # --- python conveniences -------------------------------------------------
    def __len__(self) -> int:
        return self.size()

    def __getitem__(self, i: int) -> float:
        return self.get(i)

    def __setitem__(self, i: int, value: float) -> None:
        self.set(i, value)


class DenseVector(Vector):
    """Dense vector backed by a float64 numpy array. Ref DenseVector.java."""

    __slots__ = ("values",)

    def __init__(self, values: Union[Sequence[float], np.ndarray]):
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 1:
            raise ValueError(f"DenseVector requires a 1-D array, got shape {self.values.shape}")

    def size(self) -> int:
        return int(self.values.shape[0])

    def get(self, i: int) -> float:
        return float(self.values[i])

    def set(self, i: int, value: float) -> None:
        self.values[i] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def to_dense(self) -> "DenseVector":
        return self

    def to_sparse(self) -> "SparseVector":
        nz = np.nonzero(self.values)[0]
        return SparseVector(self.size(), nz, self.values[nz])

    def clone(self) -> "DenseVector":
        return DenseVector(self.values.copy())

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseVector) and np.array_equal(self.values, other.values)

    def __hash__(self) -> int:
        return hash((self.size(), self.values.tobytes()))

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"

    def __iter__(self):
        return iter(self.values.tolist())


class SparseVector(Vector):
    """Sparse vector with sorted unique indices. Ref SparseVector.java.

    The constructor sorts (index, value) pairs and rejects duplicates/out-of-range
    indices, matching the reference's invariant checks.
    """

    __slots__ = ("n", "indices", "values")

    def __init__(
        self,
        size: int,
        indices: Union[Sequence[int], np.ndarray],
        values: Union[Sequence[float], np.ndarray],
    ):
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if indices.shape != values.shape or indices.ndim != 1:
            raise ValueError("indices and values must be 1-D arrays of the same length")
        order = np.argsort(indices, kind="stable")
        indices = indices[order]
        values = values[order]
        if indices.size:
            if indices[0] < 0 or indices[-1] >= size:
                raise ValueError(f"Index out of range [0, {size}): {indices}")
            if np.any(np.diff(indices) == 0):
                raise ValueError(f"Duplicate indices in {indices}")
        self.n = int(size)
        self.indices = indices
        self.values = values

    @classmethod
    def from_sorted(cls, size: int, indices: np.ndarray, values: np.ndarray) -> "SparseVector":
        """A vector from int64 ``indices`` that are already sorted, unique
        and in range, and float64 ``values`` — the readback of a packed
        column, whose rows keep that invariant — without re-checking it."""
        v = cls.__new__(cls)
        v.n = int(size)
        v.indices = indices
        v.values = values
        return v

    def size(self) -> int:
        return self.n

    def get(self, i: int) -> float:
        if i < 0 or i >= self.n:
            raise IndexError(i)
        pos = np.searchsorted(self.indices, i)
        if pos < self.indices.size and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def set(self, i: int, value: float) -> None:
        if i < 0 or i >= self.n:
            raise IndexError(i)
        pos = int(np.searchsorted(self.indices, i))
        if pos < self.indices.size and self.indices[pos] == i:
            self.values[pos] = value
        else:
            self.indices = np.insert(self.indices, pos, i)
            self.values = np.insert(self.values, pos, value)

    def to_array(self) -> np.ndarray:
        arr = np.zeros(self.n, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    def to_dense(self) -> DenseVector:
        return DenseVector(self.to_array())

    def to_sparse(self) -> "SparseVector":
        return self

    def clone(self) -> "SparseVector":
        return SparseVector(self.n, self.indices.copy(), self.values.copy())

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SparseVector)
            and self.n == other.n
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.values, other.values)
        )

    def __hash__(self) -> int:
        return hash((self.n, self.indices.tobytes(), self.values.tobytes()))

    def __repr__(self) -> str:
        return f"SparseVector({self.n}, {self.indices.tolist()}, {self.values.tolist()})"


class Vectors:
    """Factory methods. Ref Vectors.java."""

    @staticmethod
    def dense(*values: float) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(list(values))

    @staticmethod
    def sparse(size: int, indices: Iterable[int], values: Iterable[float]) -> SparseVector:
        return SparseVector(size, list(indices), list(values))

