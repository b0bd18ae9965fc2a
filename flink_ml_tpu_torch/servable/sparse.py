"""The sparse calling convention of the compiled plans — twin of
``flink_ml_tpu/servable/sparse.py``.

**Layout.** A SparseVector column ``c`` crosses a program boundary as three
dense tensors:

    ``c!values [n, K] f32`` · ``c!ids [n, K] i32`` · ``c!nnz [n] i32``

with each row's entries in its leading slots in sorted-unique id order, and
padding slots carrying id 0 / value 0.0 (exact identity terms under
``ops/kernels.segment_sum``). Host-featurized inputs (token lists, hashed
feature rows) enter as raw **entries**: the same triple with duplicates
allowed and the device combine pending, plus ``c!len [n] i32``, each row's
raw element count (CountVectorizer's fractional minTF reads it).

**Bucket ladder.** K is the power-of-two **nnz cap** above the batch's
longest row (``linalg.sparse_batch.ladder_cap``), so a serving plan builds
≤ 1 chain per (row bucket, nnz cap) and warmup can cover the whole ladder.
A batch whose rows exceed ``sparse.nnz.cap.max`` is **off-ladder** and
falls back per-stage.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.sparse_batch import ladder_cap
from flink_ml_tpu_torch.linalg.vectors import SparseVector

__all__ = [
    "OffLadderError",
    "SPARSE_MARK",
    "entries_names",
    "ids_name",
    "len_name",
    "nnz_name",
    "pack_entry_rows",
    "pack_sparse_column",
    "rebuild_sparse_column",
    "resolve_nnz_cap_max",
    "resolve_sparse_hints",
    "resolve_warm_caps",
    "sparse_names",
    "values_name",
]

#: Marker heading the DataType slot of a sparse output's readback parts:
#: ``(SPARSE_MARK, column, dim, "values" | "ids" | "nnz")`` — the plan
#: rebuilds the SparseVector column from the three parts.
SPARSE_MARK = "__sparse__"


def values_name(col: str) -> str:
    return f"{col}!values"


def ids_name(col: str) -> str:
    return f"{col}!ids"


def nnz_name(col: str) -> str:
    return f"{col}!nnz"


def len_name(col: str) -> str:
    return f"{col}!len"


def sparse_names(col: str) -> Tuple[str, str, str]:
    """Program-level names of a ``"sparse"``-kind column, in convention order."""
    return (values_name(col), ids_name(col), nnz_name(col))


def entries_names(col: str) -> Tuple[str, str, str, str]:
    """Program-level names of an ``"entries"``-kind (host-featurized) column."""
    return (values_name(col), ids_name(col), nnz_name(col), len_name(col))


class OffLadderError(ValueError):
    """A row's nnz exceeds ``sparse.nnz.cap.max`` — the batch cannot ride the
    nnz-cap ladder and must fall back per-stage."""


def resolve_nnz_cap_max() -> int:
    """Top rung of the nnz-cap ladder (``sparse.nnz.cap.max``)."""
    return max(1, int(config.get(Options.SPARSE_NNZ_CAP_MAX)))


def resolve_warm_caps() -> Tuple[int, ...]:
    """The nnz caps serving warmup builds per bucket: ``sparse.warmup.caps``
    when set (comma-separated, each rounded up to its rung), else the full
    power-of-two ladder up to ``sparse.nnz.cap.max``."""
    raw = config.get(Options.SPARSE_WARMUP_CAPS)
    cap_max = resolve_nnz_cap_max()
    if raw:
        caps = sorted({ladder_cap(int(c)) for c in str(raw).split(",") if str(c).strip()})
        return tuple(c for c in caps if c <= cap_max) or (cap_max,)
    caps, c = [], 1
    while c <= cap_max:
        caps.append(c)
        c *= 2
    return tuple(caps)


def _resolve_cap(max_nnz: int, cap: Optional[int], cap_max: Optional[int], truncate: bool) -> int:
    natural = ladder_cap(max_nnz)
    if cap is not None:  # a forced rung is already a ladder int
        if natural > cap and not truncate:
            raise OffLadderError(f"rows carry up to {max_nnz} entries > forced nnz cap {cap}")
        return cap
    if cap_max is not None and natural > cap_max:
        raise OffLadderError(
            f"rows carry up to {max_nnz} entries — ladder cap {natural} exceeds "
            f"sparse.nnz.cap.max={cap_max}"
        )
    return natural


def pack_sparse_column(
    df: Any,
    col: str,
    *,
    dim: Optional[int] = None,
    cap: Optional[int] = None,
    cap_max: Optional[int] = None,
    truncate: bool = False,
) -> Tuple[Dict[str, np.ndarray], int, int, int]:
    """Pack a SparseVector column into the convention triple at a ladder cap.

    Returns ``(arrays, cap, dim, nnz_total)``, ``arrays`` keyed by the three
    program names. ``cap`` forces the rung (``truncate=True`` then clips rows
    longer than it — warmup packs for shape only); otherwise the rung is
    ``ladder_cap(longest row)``, raising :class:`OffLadderError` above
    ``cap_max``."""
    vecs: List[SparseVector] = [
        v if isinstance(v, SparseVector) else v.to_sparse() for v in df.column(col)
    ]
    dims = {v.n for v in vecs}
    if dim is None:
        if len(dims) != 1:
            raise ValueError(f"column {col!r} has inconsistent dims {dims}")
        (dim,) = dims
    elif dims and dims != {dim}:
        raise ValueError(f"column {col!r} dims {dims} != expected {dim}")
    n = len(vecs)
    lens = np.fromiter((v.indices.shape[0] for v in vecs), np.int64, n)
    use = _resolve_cap(int(lens.max()) if n else 0, cap, cap_max, truncate)
    k = np.minimum(lens, use)
    ids = np.zeros((n, use), np.int32)
    values = np.zeros((n, use), np.float32)
    total = int(k.sum())
    if total:
        rows = np.repeat(np.arange(n), k)
        slots = np.arange(total) - np.repeat(np.cumsum(k) - k, k)
        clipped = [v for v, kk in zip(vecs, k) if kk]
        ids[rows, slots] = np.concatenate([v.indices[:use] for v in clipped])
        values[rows, slots] = np.concatenate([v.values[:use] for v in clipped])
    arrays = dict(zip(sparse_names(col), (values, ids, k.astype(np.int32))))
    return arrays, use, dim, total


def pack_entry_rows(
    col: str,
    rows: Sequence[Sequence[Tuple[int, float]]],
    lengths: Sequence[int],
    *,
    cap: Optional[int] = None,
    cap_max: Optional[int] = None,
    truncate: bool = False,
) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Pack host-featurized raw entries (``(id, value)`` pairs, duplicates
    allowed) into the ``"entries"`` quadruple at a ladder cap — the shared
    tail of every host ingest (HashingTF's term hashing, CountVectorizer's
    vocabulary lookup, FeatureHasher's row hashing). Returns ``(arrays, cap,
    nnz_total)``; the cap rules are :func:`pack_sparse_column`'s."""
    n = len(rows)
    lens = np.fromiter((len(r) for r in rows), np.int64, n)
    use = _resolve_cap(int(lens.max()) if n else 0, cap, cap_max, truncate)
    k = np.minimum(lens, use)
    ids = np.zeros((n, use), np.int32)
    values = np.zeros((n, use), np.float32)
    total = int(k.sum())
    if total:
        flat = [e for r in rows for e in r[:use]]
        at = (np.repeat(np.arange(n), k), np.arange(total) - np.repeat(np.cumsum(k) - k, k))
        ids[at] = np.fromiter((e[0] for e in flat), np.int64, total)
        values[at] = np.fromiter((e[1] for e in flat), np.float64, total)
    arrays = dict(zip(entries_names(col), (values, ids, k.astype(np.int32),
                                           np.asarray(lengths, np.int32))))
    return arrays, use, total


def resolve_sparse_hints(df: Optional[Any]) -> Optional[Dict[str, int]]:
    """The sparse-convention policy one plan build snapshots: ``None`` when
    ``sparse.fastpath`` is off (the planner then never asks a stage for its
    sparse spec), else the columns of ``df`` that arrive sparse, mapped to
    their dimension."""
    if not config.get(Options.SPARSE_FASTPATH):
        return None
    hints: Dict[str, int] = {}
    if df is not None:
        for name in df.get_column_names():
            if df.is_sparse(name):
                hints[name] = int(df.column(name)[0].size())
    return hints


def rebuild_sparse_column(
    dim: int, values: np.ndarray, ids: np.ndarray, nnz: np.ndarray
) -> List[SparseVector]:
    """Readback: the convention triple back into a SparseVector column — each
    row's leading ``nnz`` slots, sorted-unique by the convention's invariant.
    The inverse of :func:`pack_sparse_column`."""
    values = np.asarray(values, np.float64)
    ids = np.asarray(ids, np.int64)
    nnz = np.asarray(nnz, np.int64)
    return [
        SparseVector.from_sorted(dim, ids[i, :k].copy(), values[i, :k].copy())
        for i, k in enumerate(nnz.tolist())
    ]
