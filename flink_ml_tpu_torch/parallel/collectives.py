"""Collectives — twin of ``flink_ml_tpu/parallel/collectives.py``.

The reference's AllReduce (``AllReduceImpl.java:54-102``: a chunked
reduce-scatter and all-gather over Flink's network shuffles) is one
``torch.distributed`` collective over the mesh's process group: NCCL when
every rank holds its own card, gloo on the CPU and when ranks share one card
(NCCL refuses two ranks on one device). gloo's collectives run on host
memory, so on a CUDA device they are staged here explicitly: each partial is
copied to the host, reduced or gathered there, and copied back. The partials
are small (a gradient, per-block sums), so the staging costs little beside
an epoch. A collective that fails raises, and the fit with it.

Two tiers, as in the JAX package:

- ``psum_tree`` / ``all_reduce_sum`` / ``all_reduce_mean``: an all-reduce
  of each leaf, over a named axis of the mesh (``"model"``, ``"data"``,
  ``("slice", "data")``; the data axes when none is named) — one process
  subgroup of ``parallel/mesh.py``. The ring's summation order is the library's, so a sum at
  width N may differ from width 1 in the last ulp — the sparse and MLP
  fits ride this tier, outside the bit contract.
- The deterministic mapreduce tier: ``block_partials`` (the per-8-row-block
  sums, rows folded in order), an ``all_gather`` of every rank's partials,
  the swap back to global block order under the block-cyclic deal
  (``parallel/train_sharding.py``), and ``tree_fold_sum`` (a balanced
  pairwise fold whose shape depends on the global block count alone), run
  alike on every rank. Every add is an elementwise float add in an order the
  program fixes, so ``mapreduce_sum`` is bit-equal at every width and to the
  JAX package's on the same inputs.

The JAX tier also rests on XLA CPU's 8-row gemv blocking for the per-row
math that feeds the fold (its margins and distances). A cuBLAS or CPU BLAS
product picks its algorithm by shape, and the local batch is a shape that
changes with the width, so the port takes no product there:
``row_fold_sum`` sums a row's terms with the same pairwise fold over the
last axis, whose order depends on the row's width alone. The elementwise
functions of the rows (a loss's ``exp`` and ``log``) must not depend on the
row count either: on the CPU, ATen evaluates a vector's last partial lane
group with scalar code, whose transcendentals round differently from its
vector code, and splits long vectors over threads at count-dependent points;
``rowwise`` evaluates them on whole lane groups, one thread a chunk. A CUDA
elementwise kernel evaluates every element alike whatever the count.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from flink_ml_tpu_torch.ops.rowstable import fold_sum, rowwise
from flink_ml_tpu_torch.parallel.mesh import MeshContext, get_mesh_context

__all__ = [
    "BLOCK_ROWS",
    "all_gather_blocks",
    "all_reduce_mean",
    "all_reduce_packed",
    "all_reduce_sum",
    "all_reduce_tensor",
    "block_partials",
    "fold_partials",
    "mapreduce_sum",
    "psum_replicated",
    "psum_tree",
    "row_fold_sum",
    "rowwise",
    "tree_fold_sum",
]

#: Row-block quantum of the deterministic tier (the JAX package's, which
#: matches XLA CPU's 8-row gemv blocking).
BLOCK_ROWS = 8


def _collective(ctx: Optional[MeshContext]) -> bool:
    return ctx is not None and ctx.n_data > 1


def all_reduce_tensor(t: torch.Tensor, ctx: MeshContext, axis=None) -> torch.Tensor:
    """The elementwise sum of ``t`` over the ranks of ``ctx``'s ``axis``
    (``"model"``, ``"data"``, ``("slice", "data")``; None → the data axes),
    on every rank of it — the JAX package's ``psum(t, axis)``; ``t`` itself
    when the axis has one rank."""
    if ctx is None:
        return t
    group, size = ctx.axis_group(axis)
    if size <= 1:
        return t
    buf = t.detach().to("cpu", copy=True) if ctx.host_staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if ctx.host_staged else buf


class _PsumReplicated(torch.autograd.Function):
    """Sum of per-rank partials into a value every rank then uses alike;
    the VJP hands each rank the (replicated) cotangent unchanged."""

    @staticmethod
    def forward(fctx, t, ctx, axis):
        return all_reduce_tensor(t, ctx, axis)

    @staticmethod
    def backward(fctx, grad):
        return grad, None, None


def psum_replicated(t: torch.Tensor, ctx: Optional[MeshContext], axis=None) -> torch.Tensor:
    """``all_reduce_tensor`` with autograd: each rank's ``t`` is its partial
    of a sum that every rank goes on to use in the same replicated
    computation (a loss), so the gradient of each partial is the gradient of
    the sum — the per-rank parameter gradients it produces are partials,
    summed over the axis before an update."""
    if ctx is None or ctx.axis_group(axis)[1] <= 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _PsumReplicated.apply(t, ctx, axis)
    return all_reduce_tensor(t, ctx, axis)


def all_reduce_packed(tensors, ctx: Optional[MeshContext], axis=None) -> list:
    """``tensors`` (one dtype, any shapes) summed over ``axis`` (None → the
    data axes) in ONE all-reduce of their concatenation — a step's gradient
    and its weight and loss sums travel together, as in the JAX package's
    packed psum; returned as they are when the axis has one rank."""
    if ctx is None or ctx.axis_group(axis)[1] <= 1:
        return list(tensors)
    flat = all_reduce_tensor(torch.cat([t.reshape(-1) for t in tensors]), ctx, axis)
    out, pos = [], 0
    for t in tensors:
        out.append(flat[pos:pos + t.numel()].reshape(t.shape))
        pos += t.numel()
    return out


def psum_tree(tree: Any, ctx: Optional[MeshContext] = None, axis=None) -> Any:
    """``all_reduce_tensor`` over ``axis`` of every tensor of a
    list/tuple/dict tree."""
    ctx = ctx or get_mesh_context()
    if isinstance(tree, (list, tuple)):
        return type(tree)(psum_tree(x, ctx, axis) for x in tree)
    if isinstance(tree, dict):
        return {k: psum_tree(v, ctx, axis) for k, v in tree.items()}
    return all_reduce_tensor(tree, ctx, axis)


def all_reduce_sum(array, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Sum of every rank's [rows, ...] partition, on every rank — the
    ``DataStreamUtils.allReduceSum`` contract: each rank contributes its
    rows, every rank ends with the same total."""
    ctx = ctx or get_mesh_context()
    x = array if isinstance(array, torch.Tensor) else torch.as_tensor(array)
    return all_reduce_tensor(torch.sum(x.to(ctx.device), dim=0), ctx)


def all_reduce_mean(array, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """``all_reduce_sum`` over the global row count."""
    ctx = ctx or get_mesh_context()
    x = array if isinstance(array, torch.Tensor) else torch.as_tensor(array)
    n = all_reduce_tensor(torch.tensor(float(x.shape[0]), dtype=torch.float64, device=ctx.device), ctx)
    return all_reduce_sum(x, ctx) / n.to(x.dtype)


# --- deterministic mapreduce tier ---------------------------------------------


def block_partials(x: torch.Tensor) -> torch.Tensor:
    """[rows, ...] → [rows / BLOCK_ROWS, ...] per-block sums: each 8-row
    block folded as an explicit left chain, so a block's partial depends on
    its 8 rows alone. ``rows`` must be a multiple of BLOCK_ROWS."""
    rows = x.shape[0]
    if rows % BLOCK_ROWS:
        raise ValueError(f"deterministic reduce needs rows % {BLOCK_ROWS} == 0, got {rows}")
    xb = x.reshape((rows // BLOCK_ROWS, BLOCK_ROWS) + tuple(x.shape[1:]))
    acc = xb[:, 0]
    for r in range(1, BLOCK_ROWS):
        acc = acc + xb[:, r]
    return acc


def tree_fold_sum(blocks: torch.Tensor) -> torch.Tensor:
    """[G, ...] → [...] balanced pairwise fold over the leading axis. Its
    shape depends on G alone; an odd level pads one exact-zero block, which
    leaves finite sums unchanged bit for bit."""
    while blocks.shape[0] > 1:
        if blocks.shape[0] % 2:
            blocks = torch.cat([blocks, torch.zeros_like(blocks[:1])], dim=0)
        blocks = blocks[0::2] + blocks[1::2]
    return blocks[0]


def row_fold_sum(t: torch.Tensor) -> torch.Tensor:
    """[..., d] → [...]: each row's d terms summed by the pairwise fold of
    ``tree_fold_sum`` over the last axis — an order set by d alone, whatever
    the number of rows or the device."""
    return fold_sum(t, -1)


def all_gather_blocks(part: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Every rank's [L, ...] partials as [N · L, ...] in GLOBAL block order
    under the block-cyclic deal: rank k holds global blocks k, k + N, …, so
    gathered[k, i] is block i·N + k and a swap of the first two axes
    restores the order. The deterministic tier is data-parallel and
    single-slice only (JAX ``optimizer.py:144-148``, ``:407-410``)."""
    if ctx.n_model > 1 or ctx.n_slices > 1:
        raise ValueError(
            "deterministic reduction covers the dense data-parallel layout only "
            "(train.mesh with train.mesh.model == 1, one slice)"
        )
    src = part.detach().to("cpu", copy=True) if ctx.host_staged else part.detach().contiguous()
    got = [torch.empty_like(src) for _ in range(ctx.n_data)]
    dist.all_gather(got, src, group=ctx.group)
    g = torch.stack(got)  # [N, L, ...]
    g = g.transpose(0, 1).reshape((-1,) + tuple(g.shape[2:]))
    return g.to(part.device) if ctx.host_staged else g


def fold_partials(part: torch.Tensor, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """The global sum of every rank's [L, ...] block partials: gathered into
    global block order and folded by the same tree on every rank; the
    width-1 program (``ctx`` None or of one shard) skips the gather."""
    if _collective(ctx):
        part = all_gather_blocks(part, ctx)
    return tree_fold_sum(part)


def mapreduce_sum(x: torch.Tensor, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """Deterministic global row-sum of a rank's [rows, ...] batch dealt
    block-cyclically (``TrainSharding.deal_cache``): ``fold_partials`` of
    its ``block_partials``. Bit-identical at every width and to the width-1
    program."""
    return fold_partials(block_partials(x), ctx)
