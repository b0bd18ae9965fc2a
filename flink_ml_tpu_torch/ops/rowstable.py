"""Row-stable forms of the operations whose per-row result would otherwise
move with the number of rows in the call.

The sharded plan tier (``servable/sharding.py``) runs a bucket as ``N``
shards of ``bucket / N`` rows and holds every row bit-equal to the same row
computed inside the whole bucket. Elementwise arithmetic and a per-row
softmax keep a row's bits whatever the row count on both backends. These do
not (``tools/row_invariance.py`` lists them):

- on the CPU, ATen's vectorised transcendental functions (``exp``,
  ``sigmoid``) round differently from its scalar tail, which takes the last
  ``n mod 32`` elements of a 1-D tensor: :func:`rowwise` pads the rows to a
  multiple of 64 so every row takes the vector path; and MKL's ``sgemm``
  takes another path below 16 rows (8 rows differ from the same rows inside
  a taller product; 16, 24, 32, ... rows do not): :func:`matmul` pads a
  matrix product's rows to 16. MKL's ``sgemv`` and ATen's row sums are
  row-stable at every row count and run as they are. These forms cost a few
  pad rows, so the CPU always takes them;
- on CUDA, cuBLAS chooses its algorithm — tile and split of the reduction —
  by shape, so a row of a matrix product or of a matrix-vector product
  differs between 8 and 4096 rows at every width measured, and a row sum's
  reduction layout changes for few rows. The row-stable forms take every
  sum in a fixed order instead — the products formed elementwise, then
  added by :func:`fold_sum`'s pairwise fold, an order set by the reduced
  width alone; elementwise kernels evaluate every element alike, so that is
  row-stable by construction. It is 100–300× slower than cuBLAS a product,
  so CUDA takes it only inside :func:`required` — on the thread running a
  plan segment that has more than one data shard (``servable/planner.py``
  ``run_segment``), and wherever a caller holds such a plan against its
  mesh-1 twin. Everything else on the card — ``Model.transform``, every
  mesh-1 plan, the megakernels' plain versions, training — stays on cuBLAS
  and ATen's reductions: on CUDA a sharded plan is bit-equal per row to the
  mesh-1 plan run inside :func:`required`, and within the fast tier's ulp
  envelope of the default mesh-1 plan. The fast tier's megakernels fold each
  row in a fixed order themselves, so their keys are bit-equal either way.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["MATMUL_MIN_ROWS", "fold_sum", "matmul", "required", "rowwise", "sigmoid", "sum_last"]

#: The fewest rows MKL's sgemm computes on its row-stable path.
MATMUL_MIN_ROWS = 16

#: ``rowwise``'s padding quantum (a multiple of ATen's widest unrolled
#: float lane group, 2 × 16) and chunk (ATen's grain size, below which an
#: elementwise kernel runs on one thread).
_LANE_ROWS = 64
_CHUNK_ROWS = 32768

#: Elements of one row chunk's ``[rows, k, n]`` product tensor in a CUDA
#: :func:`matmul` (64 MB of float32).
_FOLD_ELEMENTS = 1 << 24

_state = threading.local()


@contextlib.contextmanager
def required(on: bool = True):
    """Within the block, on this thread, CUDA tensors take the row-stable
    forms too (module docstring). ``on`` false leaves the setting as it is;
    blocks nest."""
    prev = getattr(_state, "on", False)
    _state.on = prev or bool(on)
    try:
        yield
    finally:
        _state.on = prev


def _stable(t: torch.Tensor) -> bool:
    """Whether an operation on ``t`` takes its row-stable form: always on
    the CPU, on CUDA inside :func:`required`."""
    return t.device.type == "cpu" or getattr(_state, "on", False)


def rowwise(fn, *rows: torch.Tensor):
    """``fn(*rows)`` for an elementwise ``fn`` of [n] tensors returning a
    tuple of [n] tensors, each row's result the same bits whatever n. On
    the CPU the rows are zero-padded to a multiple of 64 and evaluated in
    chunks of 32,768, so every row takes ATen's vector path on one thread;
    on CUDA ``fn`` runs as it is."""
    if rows[0].device.type != "cpu":
        return fn(*rows)
    n = rows[0].shape[0]
    padded = [torch.cat([r, r.new_zeros(-n % _LANE_ROWS)]) for r in rows]
    outs = [fn(*(r[i:i + _CHUNK_ROWS] for r in padded)) for i in range(0, padded[0].shape[0], _CHUNK_ROWS)]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` of a [n] tensor, each element's bits independent of n."""
    return rowwise(lambda t: (torch.sigmoid(t),), x)[0]


def fold_sum(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``t`` summed over ``dim`` by a balanced pairwise fold (a zero appended
    to an odd length): an order set by that dimension's length alone,
    whatever the other dimensions or the device."""
    dim %= t.dim()
    even = (slice(None),) * dim + (slice(0, None, 2),)
    odd = (slice(None),) * dim + (slice(1, None, 2),)
    while t.shape[dim] > 1:
        if t.shape[dim] % 2:
            t = torch.cat([t, torch.zeros_like(t.narrow(dim, 0, 1))], dim=dim)
        t = t[even] + t[odd]
    return t.squeeze(dim)


def sum_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over its last axis: ATen's sum, or on CUDA inside
    :func:`required` :func:`fold_sum`."""
    if t.device.type == "cpu" or not _stable(t):
        return torch.sum(t, dim=-1)
    return fold_sum(t, -1)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``a`` [n, k] and ``b`` [k] or [k, m]; where
    :func:`_stable` holds, each row of the result independent of n (module
    docstring)."""
    n = a.shape[0]
    if not _stable(a):
        return a @ b
    if a.device.type == "cpu":
        if b.dim() != 2 or n >= MATMUL_MIN_ROWS:
            return a @ b
        return (torch.cat([a, a.new_zeros((MATMUL_MIN_ROWS - n,) + tuple(a.shape[1:]))]) @ b)[:n]
    if b.dim() == 1:
        return fold_sum(a * b[None, :], -1)
    k, m = b.shape
    if n == 0:
        return a.new_zeros((0, m))
    step = max(1, _FOLD_ELEMENTS // max(1, k * m))
    return torch.cat([fold_sum(a[r:r + step, :, None] * b[None, :, :], 1) for r in range(0, n, step)])
