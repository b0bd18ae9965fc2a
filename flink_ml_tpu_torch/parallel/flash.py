"""The ring-attention fold and its backward — twin of
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

Gradients. :func:`reference_fold_bwd` is the JAX package's hand-derived VJP
of the fold, op for op: max ties split as AD splits them (``m`` against the
block max takes 1, 0.5 or 0 of the gradient for ``>``, ``==``, ``<``, and
the block max's share is spread evenly over the keys equal to it). It is the
plain version of both backward kernels of ``csrc/flash_fold_bwd.cu``: the
dq kernel (:func:`fold_bwd_dq`), which owns query rows and also hands each
row's safe max, block max and ``dB / cnt`` to the dkv kernel
(:func:`fold_bwd_dkv`), which owns keys and sums ``dk``/``dv`` over every
query that attends them. :func:`fused_fold` is a ``torch.autograd.Function``
when an input requires grad: its backward (:func:`fused_fold_bwd`) launches
the two kernels for CUDA tensors and runs the plain VJP for CPU tensors. The
backward is not itself differentiable (``once_differentiable``).

Tiles. The TPU kernels stage one head's whole K/V block in VMEM, so their
gates reject a local length that is not a multiple of their Q tile or whose
block passes a VMEM budget. The CUDA kernels stream K/V (the dkv kernel: Q)
through shared memory a tile at a time and mask their own ragged edges, so
any Tq and Tk run; their one limit is the head dim their templates are built
for (:data:`MAX_HEAD_DIM`). The forward's block takes
``4 · (3 · 64 · D_pad + 64 · 64)`` bytes with the head dim padded to 16, 32,
64, 128 or 256 (:func:`fold_smem_bytes`): 114,688 at D 128 (two blocks an
SM), 212,992 at D 256, under the 232,448 bytes a Hopper block may use. The
backward kernels' budgets are :func:`fold_bwd_smem_bytes`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from flink_ml_tpu_torch.native import CudaKernel, check_tensor as _check

__all__ = [
    "FLASH_FOLD",
    "FLASH_FOLD_BWD_DKV",
    "FLASH_FOLD_BWD_DQ",
    "MAX_HEAD_DIM",
    "TILE_K",
    "TILE_Q",
    "flash_available",
    "flash_train_available",
    "fold_bwd_dkv",
    "fold_bwd_dq",
    "fold_bwd_smem_bytes",
    "fold_smem_bytes",
    "fused_fold",
    "fused_fold_bwd",
    "reference_fold",
    "reference_fold_bwd",
]

#: Query rows per block and keys per K/V tile of ``csrc/flash_fold.cu``
#: (its kBM and kBN).
TILE_Q = 64
TILE_K = 64
#: The largest head dim the kernels' templates hold.
MAX_HEAD_DIM = 256
_HEAD_DIM_PADS = (16, 32, 64, 128, 256)

FLASH_FOLD = CudaKernel(
    name="flash_fold",
    source="flash_fold.cu",
    symbol="flash_fold",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
    replaces="flink_ml_tpu/parallel/flash.py:127",
)
FLASH_FOLD_BWD_DQ = CudaKernel(
    name="flash_fold_bwd_dq",
    source="flash_fold_bwd.cu",
    symbol="flash_fold_bwd_dq",
    argtypes=[ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
    replaces="flink_ml_tpu/parallel/flash.py:463",
)
FLASH_FOLD_BWD_DKV = CudaKernel(
    name="flash_fold_bwd_dkv",
    source="flash_fold_bwd.cu",
    symbol="flash_fold_bwd_dkv",
    argtypes=[ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
    replaces="flink_ml_tpu/parallel/flash.py:499",
)


def _pad(D: int) -> int:
    return next(p for p in _HEAD_DIM_PADS if D <= p)


def fold_smem_bytes(D: int) -> int:
    """Shared memory of one block of the kernel at head dim ``D``: the Q
    tile and the K tile (transposed), the V tile and the probability tile,
    float32, with D padded to the next template width."""
    d_pad = _pad(D)
    return 4 * (TILE_Q * d_pad + TILE_K * d_pad + TILE_K * d_pad + TILE_Q * TILE_K)


def fold_bwd_smem_bytes(D: int) -> Tuple[int, int]:
    """Shared memory of one block of the (dq, dkv) kernels at head dim
    ``D``. Each block owns 64 rows (dq: queries, dkv: keys), held as a
    [64, D_pad + 4] float32 tile of each of its two owned matrices (dq: Q
    and dacc; dkv: K and V; the 4 extra columns keep every fragment load
    free of bank conflicts), and streams the other side in tiles of 16 rows
    through two stages of two such tiles (dq: K and V; dkv: Q and dacc),
    copied asynchronously while the previous stage computes. The dq kernel
    also keeps 32 max-key indices a row, the dkv kernel the streamed rows'
    safe, block max, dB / cnt and dl. 109,568 and 101,888 bytes at D 128
    (two blocks an SM), 207,872 and 200,192 at D 256 (where two warps share
    each 16 rows, each accumulating half of the columns: eight warps, one
    block an SM)."""
    own, stream, max_keys = 64, 16, 32
    tiles = 4 * (_pad(D) + 4) * (2 * own + 2 * 2 * stream)
    return tiles + 4 * own * max_keys, tiles + 4 * 2 * 4 * stream


def flash_available(T: int, D: int, device: Union[str, torch.device]) -> bool:
    """Whether the kernel runs the fold at local length ``T`` and head dim
    ``D`` on ``device``: any ``T`` (the kernel streams K/V in tiles and
    masks its ragged edges), ``1 <= D <=`` :data:`MAX_HEAD_DIM`, and a CUDA
    device. The CPU gives ``False``: it runs the plain version."""
    del T  # kept for the JAX twin's signature: the tiles stream, so no length limit
    return torch.device(device).type == "cuda" and 1 <= D <= MAX_HEAD_DIM


def flash_train_available(T: int, D: int, batch: int, n_heads: int,
                          device: Union[str, torch.device]) -> bool:
    """Whether the kernels run a training step's fold (forward and both
    backward kernels) at local length ``T``, head dim ``D``, ``batch``
    sequences and ``n_heads`` heads on ``device``: the forward's gate.

    The JAX gate is stricter than its forward's because XLA placed the
    backward's [batch·heads, T, D] outputs in the TPU's 16 MB of scoped VMEM
    when they totalled near it, and the compile failed. Nothing here is
    placed by a compiler: each backward kernel streams its tiles through
    shared memory within :func:`fold_bwd_smem_bytes` and writes its outputs
    to device memory, so their size is bounded by device memory alone, and
    the forward's limits (a CUDA device, ``1 <= D <=`` :data:`MAX_HEAD_DIM`)
    are the whole gate. At B 1, T 8192, H 4, D 128 the JAX gate says no
    (17 MB of outputs against its 9 MB budget); this one says yes."""
    del batch, n_heads  # kept for the JAX twin's signature: no output budget
    return flash_available(T, D, device)


def reference_fold(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
                   n_valid: Optional[int], scale: float):
    """The plain fold in [B, H, ...] layout, the JAX package's numerics: the
    source of truth the kernel is held against.

    ``q`` [B, H, Tq, D]; ``kb``/``vb`` [B, H, Tk, D]; ``m``/``l`` [B, H, Tq];
    ``acc`` [B, H, Tq, D]. ``q_pos0``/``k_pos0`` are the global positions of
    query and key 0; ``n_valid`` masks keys at global positions >= it (None =
    unmasked). Returns ``(new_m, new_l, new_acc)``.
    """
    s = _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale)
    block_max = torch.amax(s, dim=-1)
    new_m = torch.maximum(m, block_max)
    safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    new_l = l * correction + torch.sum(p, dim=-1)
    new_acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
    return new_m, new_l, new_acc


def _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale):
    """``q · kbᵀ · scale``, -inf where the key is masked."""
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
    return s


def reference_fold_bwd(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
                       n_valid: Optional[int], scale: float, dm, dl, dacc):
    """The fold's hand-derived VJP, op for op the JAX package's
    ``reference_fold_bwd``: the plain version of both backward kernels.
    ``dm``/``dl``/``dacc`` are the cotangents of :func:`reference_fold`'s
    outputs; returns ``(dq, dkb, dvb, dm_in, dl_in, dacc_in)``, the
    cotangents of its six tensor inputs, AD-equivalent: ``m`` against the
    block max takes 1, 0.5 or 0 of the new max's gradient for ``>``, ``==``,
    ``<`` (as ``torch.maximum`` splits it), and the block max's share is
    spread evenly over the keys equal to it (as ``torch.amax`` spreads it)."""
    s = _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale)
    B = torch.amax(s, dim=-1)
    new_m = torch.maximum(m, B)
    safe = torch.where(torch.isneginf(new_m), 0.0, new_m)
    P = torch.exp(s - safe[..., None])
    P = torch.where(torch.isneginf(s), 0.0, P)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))

    dP = dl[..., None] + torch.einsum("bhqd,bhkd->bhqk", dacc, vb)
    dv = torch.einsum("bhqk,bhqd->bhkd", P, dacc)
    dcorr = dl * l + torch.sum(dacc * acc, dim=-1)
    dl_in = dl * corr
    dacc_in = dacc * corr[..., None]
    ds = dP * P
    dsafe = -torch.sum(dP * P, dim=-1) - dcorr * corr
    dm_in = torch.where(torch.isneginf(m), 0.0, dcorr * corr)
    dnew_m = dm + torch.where(torch.isneginf(new_m), 0.0, dsafe)
    take_m = (m > B).to(m.dtype) + 0.5 * (m == B).to(m.dtype)
    dm_in = dm_in + dnew_m * take_m
    dB = dnew_m * (1.0 - take_m)
    is_max = (s == B[..., None]) & ~torch.isneginf(s)
    cnt = torch.clamp(torch.sum(is_max, dim=-1), min=1)
    ds = ds + is_max.to(ds.dtype) * (dB / cnt)[..., None]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return dq, dk, dv, dm_in, dl_in, dacc_in


def _int32(name: str, value: int) -> int:
    value = int(value)
    if not -(2 ** 31) <= value < 2 ** 31:
        raise ValueError(f"{name} {value} does not fit the kernel's int32")
    return value


def _kernel_shapes(name: str, q, kb, vb, rows=None, mats=None):
    """Raise unless a kernel's tensors are what it takes: float32,
    contiguous, on q's device; ``q`` [B, H, Tq, D] and ``kb``/``vb``
    [B, H, Tk, D] with ``1 <= D <=`` :data:`MAX_HEAD_DIM` and sizes that fit
    an int32; ``rows`` ({name: tensor}) [B, H, Tq]; ``mats`` [B, H, Tq, D].
    Returns (B, H, Tq, Tk, D)."""
    if q.dim() != 4 or kb.dim() != 4:
        raise ValueError(f"q and kb must be [B, H, T, D], got {tuple(q.shape)} and {tuple(kb.shape)}")
    B, H, Tq, D = (int(x) for x in q.shape)
    Tk = int(kb.shape[2])
    device = q.device
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{name} holds head dims 1-{MAX_HEAD_DIM}, got {D}")
    _check("q", q, (B, H, Tq, D), device)
    _check("kb", kb, (B, H, Tk, D), device)
    _check("vb", vb, (B, H, Tk, D), device)
    for label, t in (rows or {}).items():
        _check(label, t, (B, H, Tq), device)
    for label, t in (mats or {}).items():
        _check(label, t, (B, H, Tq, D), device)
    for label, size in (("B·H", B * H), ("Tq", Tq), ("Tk", Tk)):
        _int32(label, size)
    return B, H, Tq, Tk, D


def _fold_args(q_pos0, k_pos0, causal, n_valid):
    nv = 0 if n_valid is None else _int32("n_valid", n_valid)
    return (_int32("q_pos0", q_pos0), _int32("k_pos0", k_pos0), int(bool(causal)),
            int(n_valid is not None), nv)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_route(kernel: CudaKernel, q) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (the plain
    version); raise for anything else."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{kernel.name} needs CPU or CUDA tensors, got {q.device}")
    return True


def _fold(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale):
    """The forward without autograd: the plain fold for CPU tensors, the
    kernel for CUDA tensors."""
    if not _device_route(FLASH_FOLD, q):
        return reference_fold(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale)
    B, H, Tq, Tk, D = _kernel_shapes(FLASH_FOLD.name, q, kb, vb, {"m": m, "l": l}, {"acc": acc})
    args = _fold_args(q_pos0, k_pos0, causal, n_valid)
    m_out = torch.empty_like(m)
    l_out = torch.empty_like(l)
    acc_out = torch.empty_like(acc)
    if B * H and Tq:
        with torch.cuda.device(q.device):
            FLASH_FOLD.launch(
                q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(),
                B * H, Tq, Tk, D, *args, float(scale), _stream(q.device),
            )
    return m_out, l_out, acc_out


def fold_bwd_dq(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
                n_valid: Optional[int], scale: float, dm, dl, dacc):
    """The dq kernel of ``csrc/flash_fold_bwd.cu`` on CUDA tensors (the
    current stream, no synchronisation): ``(dq, dm_in, dl_in, dacc_in,
    safe, bmax, dbc)`` — the first four as :func:`reference_fold_bwd`'s,
    then each row's safe max, block max and ``dB / cnt``, which
    :func:`fold_bwd_dkv` takes. Raises for anything the kernel does not
    take (:func:`reference_fold_bwd` is the plain version)."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{FLASH_FOLD_BWD_DQ.name} takes CUDA tensors, got {q.device}")
    B, H, Tq, Tk, D = _kernel_shapes(FLASH_FOLD_BWD_DQ.name, q, kb, vb, {"m": m, "l": l, "dm": dm, "dl": dl},
                                     {"acc": acc, "dacc": dacc})
    args = _fold_args(q_pos0, k_pos0, causal, n_valid)
    dq, dacc_in = torch.empty_like(q), torch.empty_like(acc)
    dm_in, dl_in, safe, bmax, dbc = (torch.empty_like(m) for _ in range(5))
    if B * H and Tq:
        with torch.cuda.device(q.device):
            FLASH_FOLD_BWD_DQ.launch(
                q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                dm.data_ptr(), dl.data_ptr(), dacc.data_ptr(),
                dq.data_ptr(), dm_in.data_ptr(), dl_in.data_ptr(), dacc_in.data_ptr(),
                safe.data_ptr(), bmax.data_ptr(), dbc.data_ptr(),
                B * H, Tq, Tk, D, *args, float(scale), _stream(q.device),
            )
    return dq, dm_in, dl_in, dacc_in, safe, bmax, dbc


def fold_bwd_dkv(q, kb, vb, q_pos0: int, k_pos0: int, causal: bool, n_valid: Optional[int],
                 scale: float, dl, dacc, safe, bmax, dbc):
    """The dkv kernel of ``csrc/flash_fold_bwd.cu`` on CUDA tensors: ``(dk,
    dv)``, each key's sum over every query that attends it, from the row
    quantities ``safe``, ``bmax`` and ``dbc`` of :func:`fold_bwd_dq`. Keys
    that no query attends get exactly 0. Raises for anything the kernel
    does not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{FLASH_FOLD_BWD_DKV.name} takes CUDA tensors, got {q.device}")
    B, H, Tq, Tk, D = _kernel_shapes(FLASH_FOLD_BWD_DKV.name, q, kb, vb,
                                     {"dl": dl, "safe": safe, "bmax": bmax, "dbc": dbc}, {"dacc": dacc})
    args = _fold_args(q_pos0, k_pos0, causal, n_valid)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    if B * H and Tk:
        with torch.cuda.device(q.device):
            FLASH_FOLD_BWD_DKV.launch(
                q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                dl.data_ptr(), dacc.data_ptr(),
                safe.data_ptr(), bmax.data_ptr(), dbc.data_ptr(),
                dk.data_ptr(), dv.data_ptr(),
                B * H, Tq, Tk, D, *args, float(scale), _stream(q.device),
            )
    return dk, dv


def fused_fold_bwd(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
                   n_valid: Optional[int], scale: float, dm, dl, dacc):
    """:func:`reference_fold_bwd`'s contract. CPU tensors run the plain
    version; CUDA tensors launch the dq kernel, then the dkv kernel, or
    raise — there is no fallback to the plain version on the card."""
    if not _device_route(FLASH_FOLD_BWD_DQ, q):
        return reference_fold_bwd(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
    dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = fold_bwd_dq(
        q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc)
    dk, dv = fold_bwd_dkv(q, kb, vb, q_pos0, k_pos0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc)
    return dq, dk, dv, dm_in, dl_in, dacc_in


class _FusedFold(torch.autograd.Function):
    """The fold with its VJP: the twin of the JAX ``fused_fold``'s
    ``custom_vjp``. Saves the six tensor inputs; the backward is
    :func:`fused_fold_bwd`."""

    @staticmethod
    def forward(ctx, q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale):
        ctx.save_for_backward(q, kb, vb, m, l, acc)
        ctx.fold = (q_pos0, k_pos0, causal, n_valid, scale)
        return _fold(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dm, dl, dacc):
        # autograd hands zeros for an output nobody used (the ring's final
        # m); the transposes in ring.py can hand strided gradients
        grads = fused_fold_bwd(*ctx.saved_tensors, *ctx.fold,
                               dm.contiguous(), dl.contiguous(), dacc.contiguous())
        return (*grads, None, None, None, None, None)


def fused_fold(q, kb, vb, m, l, acc, q_pos0: int, k_pos0: int, causal: bool,
               n_valid: Optional[int], scale: float):
    """One fold, :func:`reference_fold`'s contract. CPU tensors run the plain
    version; CUDA tensors launch ``csrc/flash_fold.cu`` on the current stream
    (no synchronisation) into freshly allocated outputs, or raise — for a
    dtype, shape or layout the kernel does not take, or a head dim past
    :data:`MAX_HEAD_DIM`. When an input requires grad (and grad is on) the
    fold runs as an ``autograd.Function`` whose backward is
    :func:`fused_fold_bwd`: the two backward kernels on the card, the plain
    VJP on the CPU; its backward cannot be differentiated again."""
    tensors = (q, kb, vb, m, l, acc)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedFold.apply(*tensors, q_pos0, k_pos0, causal, n_valid, scale)
    return _fold(*tensors, q_pos0, k_pos0, causal, n_valid, scale)
