"""Ring attention — twin of ``flink_ml_tpu/parallel/ring.py``.

The sequence axis is sharded over the mesh's data axis: each rank holds
``T_local = T / n`` contiguous positions of q, k and v. Every rank keeps its
Q block and, at each of ``n`` steps, folds the resident K/V block into its
streaming-softmax state through ``parallel/flash.py``'s ``fused_fold`` (the
CUDA kernel for CUDA tensors, the plain fold for CPU tensors), at the global
positions ``q_pos0 = i·T_local`` and ``k_pos0 = ((i − s) mod n)·T_local``,
then hands the block to the next rank on the ring. That is ``n − 1``
rotations: the last resident block folds without rotating back (JAX
:104-113). With one rank the ring is one fold at positions 0/0.

A rotation is one ``torch.distributed`` exchange (K and V stacked into one
tensor; sent to rank ``i + 1``, received from ``i − 1``), staged through
host memory under gloo on a card as the mesh's other collectives are
(``MeshContext.host_staged``): the transport, not a fallback — the folds
still run on the card. ``torch.distributed`` send/recv has no autograd, so a
rotation is an ``autograd.Function`` whose backward rotates the gradient
the other way (JAX's ``ppermute`` transposes so): the dK/dV of a block that
came from rank r reach rank r. Gradients flow through it all — the
transposes, the chained folds (from the second step on a fold's incoming
``m``, ``l`` and ``acc`` carry gradient to the fold before it), the
rotations and ``acc / clamp(l, 1e-30)``.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.parallel.flash import fused_fold
from flink_ml_tpu_torch.parallel.mesh import DATA_AXIS, MeshContext, get_mesh_context

__all__ = ["ring_attention", "ring_attention_sharded", "rotate"]


def _exchange(x: torch.Tensor, ctx: MeshContext, axis, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places on along ``axis``'s ring, and
    the tensor of the rank ``shift`` places back received in its stead."""
    _group, ranks = ctx.axis_ranks(axis)
    n = len(ranks)
    i = ctx.axis_index(axis)
    src = x.detach().to("cpu", copy=True) if ctx.host_staged else x.detach().contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n]),
           dist.P2POp(dist.irecv, buf, ranks[(i - shift) % n])]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(x.device) if ctx.host_staged else buf


class _Rotate(torch.autograd.Function):
    """One ring step forward; its transpose (one step back) as the VJP."""

    @staticmethod
    def forward(fctx, x, ctx, axis):
        fctx.mesh = (ctx, axis)
        return _exchange(x, ctx, axis, 1)

    @staticmethod
    def backward(fctx, grad):
        ctx, axis = fctx.mesh
        return _exchange(grad.contiguous(), ctx, axis, -1), None, None


def rotate(x: torch.Tensor, ctx: MeshContext, axis=DATA_AXIS) -> torch.Tensor:
    """``x`` of the previous rank on ``axis``'s ring (this rank's goes to the
    next) — JAX's ``ppermute`` with ``perm = [(i, i + 1)]``. Differentiable;
    ``x`` itself on a ring of one rank."""
    if ctx is None or ctx.axis_group(axis)[1] <= 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rotate.apply(x, ctx, axis)
    return _exchange(x, ctx, axis, 1)


def ring_attention(q, k, v, causal: bool = False, n_valid: Optional[int] = None,
                   ctx: Optional[MeshContext] = None, axis=DATA_AXIS):
    """Attention for [B, T_local, H, D] ``q, k, v``, this rank's slice of a
    sequence sharded over ``ctx``'s ``axis`` (None or one rank: the whole
    sequence); returns [B, T_local, H, D]. With ``causal`` a position attends
    only to global positions <= its own; ``n_valid`` masks keys at global
    positions >= it (required when the sequence was padded and ``causal`` is
    off). The fold is ``fused_fold``: on the card it takes float32 and head
    dims up to ``MAX_HEAD_DIM``, and raises for anything else.
    Differentiable in ``q``, ``k`` and ``v``."""
    B, T, H, D = q.shape
    n = 1 if ctx is None else ctx.axis_group(axis)[1]
    i = 0 if n == 1 else ctx.axis_index(axis)
    scale = 1.0 / math.sqrt(D)
    # [B, H, T, D] for the fold: one transpose in, one out; K and V ride the
    # ring as one stacked tensor
    q_t = q.transpose(1, 2).contiguous()
    kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
    m = torch.full((B, H, T), -torch.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    acc = torch.zeros((B, H, T, D), dtype=q.dtype, device=q.device)
    for s in range(n):
        if s:
            kv = rotate(kv, ctx, axis)
        src = (i - s) % n
        m, l, acc = fused_fold(q_t, kv[0], kv[1], m, l, acc, i * T, src * T, causal, n_valid, scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


def ring_attention_sharded(q, k, v, causal: bool = False, ctx: Optional[MeshContext] = None,
                           n_valid: Optional[int] = None,
                           device: Optional[Union[str, torch.device]] = None):
    """Full-sequence attention of [B, T, H, D] ``q, k, v`` (tensors or numpy
    arrays, the whole sequence on every rank) with the sequence sharded over
    ``ctx``'s data axis (None → ``get_mesh_context()`` in a process group,
    else one shard on ``device``, None → the GPU): each rank takes its
    ``T / n`` positions onto its device and returns its [B, T / n, H, D] slice of the output. T
    must divide by the axis; for an uneven sequence pad q/k/v at the tail
    and pass the real length as ``n_valid``."""
    if ctx is None and dist.is_available() and dist.is_initialized():
        ctx = get_mesh_context()
    n = 1 if ctx is None else ctx.axis_group(DATA_AXIS)[1]
    T = int(np.shape(q)[1])
    if T % n:
        raise ValueError(
            f"sequence length {T} not divisible by mesh axis {n}; pad the sequence and pass n_valid"
        )
    dev = resolve_device(device) if ctx is None else ctx.device
    t = T // n
    lo = 0 if ctx is None else ctx.axis_index(DATA_AXIS) * t
    q, k, v = (
        (torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x)[:, lo:lo + t].to(dev)
        for x in (q, k, v)
    )
    return ring_attention(q, k, v, causal=causal, n_valid=n_valid, ctx=ctx)
