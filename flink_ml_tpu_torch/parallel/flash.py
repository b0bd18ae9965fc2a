"""The ring-attention fold — twin of the forward half of
``flink_ml_tpu/parallel/flash.py``.

One fold attends a Q block against one resident K/V block and folds the
scores into the streaming-softmax state ``(m, l, acc)``: the running row
max, the running sum of ``exp(s - m)`` and the running weighted sum of the
values (``parallel/ring.py``). :func:`reference_fold` is the plain PyTorch
version, op for op the JAX package's ``reference_fold``, with its ``-inf``
hygiene: rows with nothing attendable yet never produce a NaN.
:func:`fused_fold` has the same contract; for CUDA tensors it launches the
hand-written kernel ``csrc/flash_fold.cu``, for CPU tensors it runs the
plain version.

Tiles. The TPU kernel stages one head's whole K/V block in VMEM, so its gate
rejects a local length that is not a multiple of its 256-row Q tile or whose
block passes its VMEM budget. The CUDA kernel streams K/V through shared
memory in :data:`TILE_K`-key tiles, holds :data:`TILE_Q` query rows a block
and masks its own ragged edges, so any Tq and Tk run; its one limit is the
head dim its templates are built for (:data:`MAX_HEAD_DIM`). A block's
shared memory is ``4 · (3 · 64 · D_pad + 64 · 64)`` bytes with the head dim
padded to 16, 32, 64, 128 or 256 (:func:`fold_smem_bytes`): 114,688 at D 128
(two blocks an SM), 212,992 at D 256, under the 232,448 bytes a Hopper block
may use.

This slice is forward-only: the fold's backward kernels (the dq and dkv
kernels of ``_fold_bwd_pallas``) and the ``autograd.Function`` that joins
them to the forward come with SelfAttentionClassifier training (ROADMAP.md
Queue A 3), so :func:`fused_fold` refuses inputs that require grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from flink_ml_tpu_torch.native import CudaKernel, check_tensor as _check

__all__ = [
    "FLASH_FOLD",
    "MAX_HEAD_DIM",
    "TILE_K",
    "TILE_Q",
    "flash_available",
    "fold_smem_bytes",
    "fused_fold",
    "reference_fold",
]

#: Query rows per block and keys per K/V tile of ``csrc/flash_fold.cu``
#: (its kBM and kBN).
TILE_Q = 64
TILE_K = 64
#: The largest head dim the kernel's templates hold.
MAX_HEAD_DIM = 256
_HEAD_DIM_PADS = (16, 32, 64, 128, 256)

FLASH_FOLD = CudaKernel(
    name="flash_fold",
    source="flash_fold.cu",
    symbol="flash_fold",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
    replaces="flink_ml_tpu/parallel/flash.py:127",
)


def fold_smem_bytes(D: int) -> int:
    """Shared memory of one block of the kernel at head dim ``D``: the Q
    tile and the K tile (transposed), the V tile and the probability tile,
    float32, with D padded to the next template width."""
    d_pad = next(p for p in _HEAD_DIM_PADS if D <= p)
    return 4 * (TILE_Q * d_pad + TILE_K * d_pad + TILE_K * d_pad + TILE_Q * TILE_K)


def flash_available(T: int, D: int, device: Union[str, torch.device]) -> bool:
    """Whether the kernel runs the fold at local length ``T`` and head dim
    ``D`` on ``device``: any ``T`` (the kernel streams K/V in tiles and
    masks its ragged edges), ``1 <= D <=`` :data:`MAX_HEAD_DIM`, and a CUDA
    device. The CPU gives ``False``: it runs the plain version."""
    del T  # kept for the JAX twin's signature: the tiles stream, so no length limit
    return torch.device(device).type == "cuda" and 1 <= D <= MAX_HEAD_DIM


def reference_fold(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
                   n_valid: Optional[int], scale: float):
    """The plain fold in [B, H, ...] layout, the JAX package's numerics: the
    source of truth the kernel is held against.

    ``q`` [B, H, Tq, D]; ``kb``/``vb`` [B, H, Tk, D]; ``m``/``l`` [B, H, Tq];
    ``acc`` [B, H, Tq, D]. ``q_pos0``/``k_pos0`` are the global positions of
    query and key 0; ``n_valid`` masks keys at global positions >= it (None =
    unmasked). Returns ``(new_m, new_l, new_acc)``.
    """
    Tq, Tk = q.shape[2], kb.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, kb) * scale
    if causal or n_valid is not None:
        q_pos = q_pos0 + torch.arange(Tq, device=q.device)
        k_pos = k_pos0 + torch.arange(Tk, device=q.device)
        mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if n_valid is not None:
            mask &= (k_pos < n_valid)[None, :]
        s = torch.where(mask[None, None], s, -torch.inf)
    block_max = torch.amax(s, dim=-1)
    new_m = torch.maximum(m, block_max)
    safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    new_l = l * correction + torch.sum(p, dim=-1)
    new_acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
    return new_m, new_l, new_acc


def _int32(name: str, value: int) -> int:
    value = int(value)
    if not -(2 ** 31) <= value < 2 ** 31:
        raise ValueError(f"{name} {value} does not fit the kernel's int32")
    return value


def fused_fold(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
               n_valid: Optional[int], scale: float):
    """One fold, :func:`reference_fold`'s contract. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/flash_fold.cu`` on the current stream
    (no synchronisation) into freshly allocated outputs, or raise — for a
    dtype, shape or layout the kernel does not take, or a head dim past
    :data:`MAX_HEAD_DIM`. Inputs that require grad raise
    ``NotImplementedError``: the backward kernels are not ported yet."""
    tensors = (q, kb, vb, m, l, acc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "fused_fold has no backward yet: the fold's backward kernels come with "
            "SelfAttentionClassifier training (ROADMAP.md Queue A 3)"
        )
    if q.device.type == "cpu":
        return reference_fold(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"{FLASH_FOLD.name} needs CPU or CUDA tensors, got {q.device}")
    if q.dim() != 4 or kb.dim() != 4:
        raise ValueError(f"q and kb must be [B, H, T, D], got {tuple(q.shape)} and {tuple(kb.shape)}")
    B, H, Tq, D = (int(x) for x in q.shape)
    Tk = int(kb.shape[2])
    device = q.device
    if not flash_available(Tk, D, device):
        raise ValueError(f"{FLASH_FOLD.name} holds head dims 1-{MAX_HEAD_DIM}, got {D}")
    _check("q", q, (B, H, Tq, D), device)
    _check("kb", kb, (B, H, Tk, D), device)
    _check("vb", vb, (B, H, Tk, D), device)
    _check("m", m, (B, H, Tq), device)
    _check("l", l, (B, H, Tq), device)
    _check("acc", acc, (B, H, Tq, D), device)
    for name, size in (("B·H", B * H), ("Tq", Tq), ("Tk", Tk)):
        _int32(name, size)
    pos = (_int32("q_pos0", q_pos0), _int32("k_pos0", k_pos0))
    nv = 0 if n_valid is None else _int32("n_valid", n_valid)
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    acc_out = torch.empty_like(acc)
    if B * H and Tq:
        with torch.cuda.device(device):
            FLASH_FOLD.launch(
                q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(),
                B * H, Tq, Tk, D, *pos, int(bool(causal)), int(n_valid is not None), nv,
                float(scale), torch.cuda.current_stream(device).cuda_stream,
            )
    return m_out, l_out, acc_out
