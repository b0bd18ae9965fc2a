"""Expert-parallel mixture-of-experts dispatch — twin of
``flink_ml_tpu/parallel/moe.py``.

Switch routing, as in the JAX package: experts and tokens shard over the
mesh's data axis (each rank owns ``E / n`` expert FFNs and ``T / n``
tokens); each rank routes its tokens top-1 (router logits → expert, gate
probability), packs them into fixed-capacity per-expert slots (a token past
its expert's ``capacity`` is dropped and contributes zero — written to the
out-of-range slot ``capacity``, which is cut away, so it never races the
slot's rightful occupant), one ``all_to_all`` carries every slot to the rank
owning its expert, the owner runs its experts as one batched matmul pair,
and the reverse ``all_to_all`` returns the outputs to the token's home rank,
where they combine scaled by the gate.

The ``all_to_all`` is one ``torch.distributed.all_to_all_single`` over the
data axis's process group, staged through host memory under gloo on a card
(``MeshContext.host_staged``), as the mesh's other collectives are. It is
an ``autograd.Function`` whose backward is the same exchange of the
gradient (an all-to-all is its own transpose), so ``moe_ffn`` is
differentiable in ``x``, ``router``, ``w1`` and ``w2`` like its twin. The
JAX module holds no Pallas kernel: the expert products are ``torch.einsum``
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.parallel.mesh import DATA_AXIS, MeshContext, get_mesh_context

__all__ = ["all_to_all", "moe_ffn", "moe_ffn_sharded", "route_top1"]


def _exchange(x: torch.Tensor, ctx: MeshContext, axis) -> torch.Tensor:
    group, _size = ctx.axis_group(axis)
    src = x.detach().to("cpu", copy=True) if ctx.host_staged else x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if ctx.host_staged else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis):
        fctx.mesh = (ctx, axis)
        return _exchange(x, ctx, axis)

    @staticmethod
    def backward(fctx, grad):
        ctx, axis = fctx.mesh
        return _exchange(grad.contiguous(), ctx, axis), None, None


def all_to_all(x: torch.Tensor, ctx: Optional[MeshContext], axis=DATA_AXIS) -> torch.Tensor:
    """``x`` [n, ...]: block j goes to rank j of ``axis``, and block j of the
    result came from rank j (JAX ``lax.all_to_all`` with split and concat
    axis 0). Differentiable; ``x`` itself on an axis of one rank."""
    if ctx is None or ctx.axis_group(axis)[1] <= 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, ctx, axis)
    return _exchange(x, ctx, axis)


def route_top1(x, router, capacity: int):
    """Top-1 routing of tokens ``x [t, d]`` by ``router [d, E]``:
    ``(expert [t], gate [t], slot [t], keep [t])`` — each token's expert, its
    softmax probability, its place in that expert's queue (stable order) and
    whether the place is inside ``capacity``."""
    probs = torch.softmax(x @ router, dim=-1)  # [t, E]
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    one_hot = F.one_hot(expert, router.shape[1])
    slot = torch.sum((torch.cumsum(one_hot, dim=0) - 1) * one_hot, dim=1)
    return expert, gate, slot, slot < capacity


def moe_ffn(x, router, w1, w2, capacity: int, ctx: Optional[MeshContext] = None, axis=DATA_AXIS):
    """Top-1 expert-parallel FFN of this rank's tokens.

    ``x [t, d]`` — this rank's tokens; ``router [d, E]`` replicated;
    ``w1 [e_local, d, h]`` / ``w2 [e_local, h, d]`` — this rank's experts
    (``E = e_local · n``; expert ``e`` lives on rank ``e // e_local`` of
    ``ctx``'s ``axis``; None or one rank: every expert here). ``capacity``:
    the most tokens any (rank → expert) pair sends a step. Returns
    ``[t, d]``, the dropped tokens' rows exactly zero."""
    n = 1 if ctx is None else ctx.axis_group(axis)[1]
    t, d = x.shape
    e_local = w1.shape[0]
    E = e_local * n
    expert, gate, slot, keep = route_top1(x, router, capacity)
    # overflow writes to slot ``capacity``, which is cut away
    safe_slot = torch.where(keep, slot, capacity)
    buf = x.new_zeros((E, capacity + 1, d)).index_put((expert, safe_slot), x)[:, :capacity]

    # every slot to the rank owning its expert: [n (source rank), e_local, capacity, d]
    recv = all_to_all(buf.reshape(n, e_local, capacity, d), ctx, axis)
    recv_tokens = recv.transpose(0, 1).reshape(e_local, n * capacity, d)
    h = torch.relu(torch.einsum("ecd,edh->ech", recv_tokens, w1))
    out_tokens = torch.einsum("ech,ehd->ecd", h, w2)  # [e_local, n·capacity, d]

    # the outputs back to each token's home rank
    back = out_tokens.reshape(e_local, n, capacity, d).transpose(0, 1)
    returned = all_to_all(back.contiguous(), ctx, axis).reshape(E, capacity, d)

    gathered = returned[expert, torch.where(keep, slot, 0)]  # [t, d]
    return torch.where(keep[:, None], gathered * gate[:, None], torch.zeros_like(gathered))


def moe_ffn_sharded(x, router, w1, w2, capacity: int, ctx: Optional[MeshContext] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """Expert-parallel FFN over the mesh's data axis: ``x [T, d]``,
    ``router [d, E]``, ``w1 [E, d, h]`` and ``w2 [E, h, d]`` (tensors or
    numpy arrays, whole on every rank); each rank takes its ``T / n``
    tokens and ``E / n`` experts onto its device and returns its ``[T / n,
    d]`` slice of the output. ``T`` and ``E`` must divide by the axis.
    ``ctx`` None: ``get_mesh_context()`` in a process group, else one rank
    on ``device`` (None → the GPU)."""
    if ctx is None and dist.is_available() and dist.is_initialized():
        ctx = get_mesh_context()
    n = 1 if ctx is None else ctx.axis_group(DATA_AXIS)[1]
    T, E = int(np.shape(x)[0]), int(np.shape(w1)[0])
    if T % n or E % n:
        raise ValueError(f"tokens ({T}) and experts ({E}) must divide by the mesh axis ({n})")
    dev = resolve_device(device) if ctx is None else ctx.device
    i = 0 if ctx is None else ctx.axis_index(DATA_AXIS)

    def local(a, size):
        a = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return a[i * size:(i + 1) * size].to(dev)

    router = (torch.from_numpy(np.ascontiguousarray(router)) if isinstance(router, np.ndarray) else router).to(dev)
    return moe_ffn(local(x, T // n), router, local(w1, E // n), local(w2, E // n), capacity, ctx)
