"""Ring attention on one shard — twin of ``flink_ml_tpu/parallel/ring.py``.

The JAX package shards the sequence axis over its mesh: every shard keeps
its Q block, and at each of ``n_shards`` steps folds the resident K/V block
into its streaming-softmax state, then passes the block to the next shard
(``ppermute``). The port's ring is one shard today: the whole sequence is
the local block, and attention is one fold at ``q_pos0 = k_pos0 = 0``
through ``parallel/flash.py``'s ``fused_fold`` — the CUDA kernel for CUDA
tensors, the plain fold for CPU tensors. Gradients flow through it all: the
transposes, the fold (an ``autograd.Function`` whose backward is the two
backward kernels on the card, the plain VJP on the CPU) and
``acc / clamp(l, 1e-30)``. Rotating K/V over ranks (``torch.distributed``
send/recv over the training mesh of ``parallel/mesh.py``) is the part of
ROADMAP.md Queue A 6 still to come; the fold already takes the global
positions a rotation would give it.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.parallel.flash import fused_fold

__all__ = ["ring_attention", "ring_attention_sharded"]


def ring_attention(q, k, v, causal: bool = False, n_valid: Optional[int] = None):
    """Attention for [B, T, H, D] ``q, k, v`` held by one shard; returns
    [B, T, H, D]. With ``causal`` a position attends only to positions <= its
    own; ``n_valid`` masks keys at positions >= it (required when the
    sequence was padded and ``causal`` is off). The fold is ``fused_fold``:
    on the card it takes float32 and head dims up to ``MAX_HEAD_DIM``, and
    raises for anything else. Differentiable in ``q``, ``k`` and ``v``."""
    B, T, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    # [B, H, T, D] for the fold: one transpose in, one out
    q_t, k_t, v_t = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m0 = torch.full((B, H, T), -torch.inf, dtype=q.dtype, device=q.device)
    l0 = torch.zeros((B, H, T), dtype=q.dtype, device=q.device)
    acc0 = torch.zeros((B, H, T, D), dtype=q.dtype, device=q.device)
    m, l, acc = fused_fold(q_t, k_t, v_t, m0, l0, acc0, 0, 0, causal, n_valid, scale)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


def ring_attention_sharded(q, k, v, causal: bool = False, n_valid: Optional[int] = None,
                           device: Optional[Union[str, torch.device]] = None):
    """Full-sequence attention of [B, T, H, D] ``q, k, v`` (tensors or numpy
    arrays) on ``device`` (None → the GPU), the one-device form of the JAX
    package's ``ring_attention_sharded``. For an uneven sequence pad q/k/v
    at the tail and pass the real length as ``n_valid``. Returns a tensor on
    ``device``."""
    dev = resolve_device(device)
    q, k, v = (
        (torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x).to(dev)
        for x in (q, k, v)
    )
    return ring_attention(q, k, v, causal=causal, n_valid=n_valid)
