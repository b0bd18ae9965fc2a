"""Small shared host-side (numpy) array idioms — twin of
``flink_ml_tpu/utils/arrays.py``.

The one-hot sparse layout builder (``linalg/onehot_sparse.py``) buckets
feature blocks by power-of-two occupancy and ranks elements within sorted
groups with these.
"""
from __future__ import annotations

import numpy as np

__all__ = ["next_pow2", "group_ranks"]


def next_pow2(x: np.ndarray) -> np.ndarray:
    """Elementwise smallest power of two >= x (x clamped up to 1)."""
    return (1 << np.ceil(np.log2(np.maximum(x, 1))).astype(np.int64)).astype(np.int64)


def group_ranks(sorted_keys: np.ndarray) -> np.ndarray:
    """Rank of each element within its run of equal keys (keys must be sorted).

    ``[5, 5, 7, 9, 9, 9] -> [0, 1, 0, 0, 1, 2]`` — the scatter-free way to
    build ELL rows: position = group_base[key] + rank.
    """
    return np.arange(sorted_keys.size, dtype=np.int64) - np.searchsorted(
        sorted_keys, sorted_keys
    )
