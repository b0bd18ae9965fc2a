"""Padded-CSR (ELL) sparse batches — twin of ``flink_ml_tpu/linalg/sparse_batch.py``.

``indices [n, K] int32`` and ``values [n, K] float32`` with ``K`` the largest
row nnz rounded up to a multiple of 8; padding slots carry index 0 and value
0.0, so they add nothing to a dot or a gradient. Wide sparse training reads
these two arrays and never densifies.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from flink_ml_tpu_torch.linalg.vectors import Vector

__all__ = ["SparseBatch", "ladder_cap"]

_LANE = 8  # pad K to a multiple of this, as the JAX package does


def ladder_cap(max_nnz: int) -> int:
    """The nnz-per-row bucket ladder of the sparse serving path: the
    smallest power of two ≥ ``max_nnz`` (floor 1), so a ragged batch pads
    its row width to a rung and the chain set stays ≤ 1 per (row bucket,
    nnz cap)."""
    cap = 1
    while cap < max(1, int(max_nnz)):
        cap *= 2
    return cap


class SparseBatch:
    """A batch of sparse rows in padded-CSR layout: ``dim`` is the feature
    width, ``indices``/``values`` are [n, K] with zero padding."""

    __slots__ = ("dim", "indices", "values")

    def __init__(self, dim: int, indices: np.ndarray, values: np.ndarray):
        indices = np.asarray(indices, np.int32)
        values = np.asarray(values, np.float32)
        if indices.shape != values.shape or indices.ndim != 2:
            raise ValueError(
                f"indices/values must be matching [n, K] arrays, got "
                f"{indices.shape} vs {values.shape}"
            )
        self.dim = int(dim)
        self.indices = indices
        self.values = values

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def width(self) -> int:
        return self.indices.shape[1]

    @classmethod
    def from_vectors(cls, vectors: Sequence[Vector]) -> "SparseBatch":
        """Pack SparseVectors of one size into one batch."""
        if not len(vectors):
            raise ValueError("empty batch")
        dims = {v.size() for v in vectors}
        if len(dims) != 1:
            raise ValueError(f"inconsistent vector sizes {dims}")
        (dim,) = dims
        max_nnz = max(1, max(len(v.indices) for v in vectors))
        K = -(-max_nnz // _LANE) * _LANE
        n = len(vectors)
        indices = np.zeros((n, K), np.int32)
        values = np.zeros((n, K), np.float32)
        for i, v in enumerate(vectors):
            k = len(v.indices)
            indices[i, :k] = v.indices
            values[i, :k] = v.values
        return cls(dim, indices, values)

    def __repr__(self) -> str:
        return f"SparseBatch(n={self.n}, dim={self.dim}, width={self.width})"
