"""One-hot sparse training — twin of ``flink_ml_tpu/linalg/onehot_sparse.py``.

SGD re-reads the same cached rows every epoch, so the sparsity pattern is
static. The JAX package turns it into a host-built class-major layout
(:class:`OneHotSparseLayout`): per (window, sub-batch) unit, packed stacks of
lane (int8), sub-batch-relative row id (int16) and value (f32) per slot, with
feature blocks of 128 grouped by power-of-two occupancy so each class's
coefficient rows are a contiguous slice. A minibatch step
(:func:`onehot_batch_step`) then runs

1. ``gather_round`` — each slot's coefficient (plain torch: exact indexing);
2. the **dot crossing** — per-slot values summed by row;
3. the loss multiplier per row;
4. the **mult crossing** — each row's multiplier broadcast back to its slots;
5. ``scatter_round`` — slot values summed into the permuted gradient.

The two crossings are the JAX package's Pallas kernels, in a build form (row
one-hots built per call from the row ids) and a premat form (row one-hots
materialised once per layout, :func:`premat_row_onehots`). Here each is a
hand-written CUDA kernel in ``csrc/onehot_crossing.cu``:

- ``dot_crossing`` replaces ``dot_crossing_pallas`` (``pallas_call`` :542);
- ``mult_crossing`` replaces ``mult_crossing_pallas`` (:595);
- ``dot_crossing_premat`` replaces ``dot_crossing_premat_pallas`` (:750);
- ``mult_crossing_premat`` replaces ``mult_crossing_premat_pallas`` (:799);

and each ``*_plain`` function beside it is its plain version.

Each wrapper chooses by the device of its tensors: CPU tensors take the plain
version (the JAX XLA form in torch: split-bf16 halves, f32 accumulation),
CUDA tensors launch the kernel or raise.

**Determinism and the premat/build identity.** The dot kernels never use
atomics. Both sum each output's terms in ascending entry order inside fixed
chunks of :data:`DOT_CHUNK` entries (one f32 accumulator per split half,
the halves added at the chunk's end), then add the chunk sums in ascending
chunk order. The build form walks a row-sorted entry order
(:func:`row_order`, built once per layout); the premat form walks the
one-hots, whose zero terms leave every sum unchanged. So the two forms give
bit-identical rows, and the mult kernels — one nonzero term per output —
give ``float(bf16(m)) + float(bf16(m − bf16(m)))`` bit for bit, as the JAX
XLA form does.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flink_ml_tpu_torch.native import CudaKernel
from flink_ml_tpu_torch.ops.schedule import offset_schedule
from flink_ml_tpu_torch.utils.arrays import group_ranks, next_pow2

__all__ = [
    "BLOCK",
    "DOT_CHUNK",
    "DOT_CROSSING",
    "DOT_CROSSING_PREMAT",
    "MULT_CROSSING",
    "MULT_CROSSING_PREMAT",
    "OneHotSparseLayout",
    "OneHotSparsePlan",
    "SUB_ROWS",
    "block_counts",
    "dot_crossing",
    "dot_crossing_plain",
    "dot_crossing_premat",
    "dot_crossing_premat_plain",
    "gather_round",
    "mult_crossing",
    "mult_crossing_plain",
    "mult_crossing_premat",
    "mult_crossing_premat_plain",
    "onehot_batch_step",
    "premat_bytes",
    "premat_row_onehots",
    "row_order",
    "scatter_round",
    "validate_indices",
]

BLOCK = 128  # feature-block width
SUB_ROWS = 16384  # sub-batch rows per crossing (gradient accumulation grain)
_ROW_LO = 128  # row-id split minor width
#: Entries per partial sum of both dot kernels. One constant for both keeps
#: the build and premat forms bit-identical; it also sets the premat kernel's
#: work units (one per chunk, sub-batch and group of 128 ``h`` rows, walked by
#: a persistent block per SM). At the headline shape 4096 leaves 8.24 units
#: a block (8192: 4.12, whose last round ran on 16 of 132 SMs) for a 71 MB
#: partial buffer.
DOT_CHUNK = 4096
# Elements of the largest one-hot product scatter_round materialises at once.
_SCATTER_CHUNK_ELEMS = 1 << 26
_TILE = 8192  # the JAX premat storage pad (its Pallas tile), kept for equal shapes

#: The build-form dot kernel's tiles, as ``csrc/onehot_crossing.cu`` sets
#: them: a warp takes ``DOT_ROWS`` consecutive rows of one sub-batch (a lane a
#: row), a block ``DOT_WARPS`` warps; a warp stages at most ``DOT_STAGE``
#: entry ids of its rows' contiguous range at a time (12 KB), a longer range
#: is walked in pieces; a lane has the q of ``DOT_BATCH`` of its row's
#: entries in flight at a time.
DOT_ROWS, DOT_WARPS, DOT_STAGE, DOT_BATCH = 32, 8, 3072, 8
MULT_GROUP = 8  # slots a thread of the mult kernel reads as one 16-byte word of row ids

_SOURCE = "onehot_crossing.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
DOT_CROSSING = CudaKernel(
    name="onehot_dot_crossing",
    source=_SOURCE,
    symbol="onehot_dot_crossing",
    argtypes=[_P] * 4 + [_I] * 4 + [_P],
    replaces="flink_ml_tpu/linalg/onehot_sparse.py:542",
)
MULT_CROSSING = CudaKernel(
    name="onehot_mult_crossing",
    source=_SOURCE,
    symbol="onehot_mult_crossing",
    argtypes=[_P] * 3 + [_I] * 3 + [_P],
    replaces="flink_ml_tpu/linalg/onehot_sparse.py:595",
)
DOT_CROSSING_PREMAT = CudaKernel(
    name="onehot_dot_crossing_premat",
    source=_SOURCE,
    symbol="onehot_dot_crossing_premat",
    argtypes=[_P] * 5 + [_I] * 7 + [_P],
    replaces="flink_ml_tpu/linalg/onehot_sparse.py:750",
)
MULT_CROSSING_PREMAT = CudaKernel(
    name="onehot_mult_crossing_premat",
    source=_SOURCE,
    symbol="onehot_mult_crossing_premat",
    argtypes=[_P] * 4 + [_I] * 4 + [_P],
    replaces="flink_ml_tpu/linalg/onehot_sparse.py:799",
)


def validate_indices(indices: np.ndarray, dim: int) -> None:
    if indices.size and (np.any(indices < 0) or np.any(indices >= dim)):
        bad_lo, bad_hi = indices.min(), indices.max()
        raise ValueError(f"feature index out of range [0, {dim}): [{bad_lo}, {bad_hi}]")


def block_counts(indices: np.ndarray, values: np.ndarray, nblk: int) -> np.ndarray:
    """Per-feature-block nonzero-entry counts for one sub-batch unit
    (``[rows, K]`` padded-CSR slices; value 0 = padding)."""
    blocks = np.asarray(indices, np.int64)[np.asarray(values) != 0.0] // BLOCK
    return np.bincount(blocks, minlength=nblk)


class OneHotSparsePlan:
    """The static class structure of one layout (JAX ``OneHotSparsePlan``).

    Built from per-block maximum entry counts over every sub-batch unit:
    each block's count rounds up to a power of two (its class width), and
    blocks are ordered by class. ``class_meta`` holds ``(n_blocks_local,
    width, flat_offset, block_offset)`` per nonempty class; ``perm``/
    ``inv_perm`` map block ids between original and class-major order;
    ``base_of_pos`` is the first (shard-local) flat slot of the block at
    each class-major position.

    **Tensor parallelism** (``n_model > 1``): each class's block count is
    padded to a multiple of ``n_model`` and its blocks dealt round-robin to
    the model shards (``owner_of_pos``, ``local_block_of_pos``), so every
    shard carries the same ``class_meta`` and ``n_flat`` — one shard's
    local layout — and owns a contiguous slice of every class. The
    coefficient lives shard-major, ``[n_model, nblk_local, BLOCK]``
    flattened; a rank holds its ``[nblk_local · BLOCK]`` row of it.
    """

    __slots__ = (
        "dim", "nblk", "nblk_local", "n_model", "sub_batch", "n_flat", "class_meta", "perm",
        "inv_perm", "width_of_pos", "owner_of_pos", "base_of_pos", "local_block_of_pos",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @classmethod
    def from_max_counts(cls, max_count: np.ndarray, dim: int, sub_batch: int,
                        n_model: int = 1) -> "OneHotSparsePlan":
        if sub_batch > np.iinfo(np.int16).max:
            # the packed int16 rowid would wrap and silently drop entries
            raise ValueError(
                f"sub_batch {sub_batch} exceeds the packed rowid range "
                f"({np.iinfo(np.int16).max}); use sub_rows <= 32767"
            )
        nblk = -(-dim // BLOCK)
        occ = next_pow2(np.maximum(np.asarray(max_count, np.int64), 0))
        occ[np.asarray(max_count) == 0] = 0  # empty blocks: zero slots
        order = np.argsort(occ, kind="stable")
        perm = order.astype(np.int32)  # class position -> original block id
        inv_perm = np.empty(nblk, np.int32)
        inv_perm[order] = np.arange(nblk, dtype=np.int32)
        occ_sorted = occ[order]

        class_meta: List[Tuple[int, int, int, int]] = []
        owner_of_pos = np.zeros(nblk, np.int32)
        base_of_pos = np.zeros(nblk, np.int64)
        local_block_of_pos = np.zeros(nblk, np.int64)
        flat_off = 0  # shard-local flat offset
        block_off = 0  # shard-local block offset
        widths, first = np.unique(occ_sorted, return_index=True)
        ends = np.append(first[1:], nblk)
        for wdt, p0, p1 in zip(widths, first, ends):
            f_c = int(p1 - p0)
            local_f = -(-f_c // n_model)  # padded: the same local count on every shard
            rel = np.arange(f_c, dtype=np.int64)
            owner_of_pos[p0:p1] = (rel % n_model).astype(np.int32)
            local_block_of_pos[p0:p1] = block_off + rel // n_model
            if wdt > 0:
                # Zero-width classes own coefficient blocks but no slots and
                # no round: never-observed features keep their coefficient
                # (and its regularisation) like the scatter path.
                base_of_pos[p0:p1] = flat_off + (rel // n_model) * int(wdt)
                class_meta.append((local_f, int(wdt), flat_off, block_off))
                flat_off += local_f * int(wdt)
            block_off += local_f
        if flat_off == 0:
            raise ValueError("no nonzero entries; nothing to train on")
        return cls(
            dim=int(dim), nblk=nblk, nblk_local=block_off, n_model=int(n_model),
            sub_batch=int(sub_batch), n_flat=flat_off, class_meta=tuple(class_meta), perm=perm,
            inv_perm=inv_perm, width_of_pos=occ_sorted.astype(np.int64), owner_of_pos=owner_of_pos,
            base_of_pos=base_of_pos, local_block_of_pos=local_block_of_pos,
        )

    @property
    def row_hi(self) -> int:
        """Row-id split major width of a sub-batch (``ceil(sub_batch / 128)``)."""
        return -(-self.sub_batch // _ROW_LO)

    def stack_bytes(self, n_units: int) -> int:
        """Bytes of ``n_units`` units' packed stacks across every model
        shard (int8 lane + int16 rowid + f32 value per slot)."""
        return 7 * n_units * self.n_model * self.n_flat

    def fill_unit(self, idx_u, val_u, out_lidx, out_rowid, out_lvals, model_index: int = 0) -> None:
        """Transpose one sub-batch unit ([rows <= sub_batch, K] padded CSR)
        into model shard ``model_index``'s class-major stack slices
        (preallocated, zeroed, [n_flat]); the other shards' entries are left
        out. Raises if a block's entry count exceeds its planned width."""
        idx_u = np.asarray(idx_u, np.int64)
        val_u = np.asarray(val_u)
        nz = val_u != 0.0
        rows_rel = np.repeat(
            np.arange(idx_u.shape[0], dtype=np.int64), idx_u.shape[1]
        ).reshape(idx_u.shape)[nz]
        feats = idx_u[nz]
        lanes = (feats % BLOCK).astype(np.int8)
        pos = self.inv_perm[feats // BLOCK].astype(np.int64)
        o2 = np.argsort(pos, kind="stable")
        sp = pos[o2]
        ranks = group_ranks(sp)
        if sp.size and int(np.max(ranks - self.width_of_pos[sp])) >= 0:
            raise ValueError(
                "sub-batch unit exceeds the plan's per-block occupancy — the "
                "plan was built from a counting pass that did not cover this data"
            )
        slot, lanes, rows_rel, vals = self.base_of_pos[sp] + ranks, lanes[o2], rows_rel[o2], val_u[nz][o2]
        if self.n_model > 1:  # this model shard's entries only
            mine = self.owner_of_pos[sp] == model_index
            slot, lanes, rows_rel, vals = slot[mine], lanes[mine], rows_rel[mine], vals[mine]
        out_lidx[slot] = lanes
        out_rowid[slot] = rows_rel.astype(np.int16)
        out_lvals[slot] = vals

    def permute_coef(self, coef: np.ndarray) -> np.ndarray:
        """Original [dim] coefficient -> shard-major class-major padded
        ``[n_model * nblk_local * BLOCK]`` (for ``n_model == 1`` the plain
        class-major permutation)."""
        coef = np.asarray(coef)
        c = np.zeros((self.nblk, BLOCK), coef.dtype)
        c.reshape(-1)[: self.dim] = coef
        out = np.zeros((self.n_model, self.nblk_local, BLOCK), coef.dtype)
        out[self.owner_of_pos, self.local_block_of_pos] = c[self.perm]
        return out.reshape(-1)

    def unpermute_coef(self, coef_perm: np.ndarray) -> np.ndarray:
        """Shard-major padded coefficient -> original [dim]."""
        c = np.asarray(coef_perm).reshape(self.n_model, self.nblk_local, BLOCK)
        orig = np.zeros((self.nblk, BLOCK), c.dtype)
        orig[self.perm] = c[self.owner_of_pos, self.local_block_of_pos]
        return orig.reshape(-1)[: self.dim]

    def __repr__(self) -> str:
        return (
            f"OneHotSparsePlan(dim={self.dim}, sub={self.sub_batch}, "
            f"flat={self.n_flat}, n_model={self.n_model}, "
            f"classes={[(f, w) for f, w, _, _ in self.class_meta]})"
        )


class OneHotSparseLayout:
    """Static host-built layout for one resident dataset and minibatch
    schedule: a :class:`OneHotSparsePlan` plus one rank's filled
    ``[n_windows, n_sub, n_flat]`` stacks — its ``(data shard, model
    shard)`` cell of the JAX layout's ``[n_shards, n_model, n_windows,
    n_sub, n_flat]``. Windows are the distinct minibatch slice starts of
    ``offset_schedule``."""

    __slots__ = (
        "plan", "dim", "n_windows", "n_sub", "n_flat", "nblk", "n_model", "class_meta",
        "perm", "inv_perm", "lidx", "rowid", "lvals", "window_starts",
        "local_batch", "sub_batch",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @classmethod
    def build(
        cls,
        indices: np.ndarray,
        values: np.ndarray,
        dim: int,
        local_batch: int,
        sub_rows: int = SUB_ROWS,
        max_stack_bytes: Optional[int] = None,
        n_shards: int = 1,
        shard: int = 0,
        n_model: int = 1,
        model_index: int = 0,
    ) -> Optional["OneHotSparseLayout"]:
        """Transpose a padded-CSR batch ([n, K], value 0 = padding) into
        per-(window, sub-batch) class-major stacks. With ``max_stack_bytes``,
        returns None (after the counting pass, before any stack is
        allocated) when one shard's stacks would exceed it. Float values pack
        into an f32 stack.

        On a mesh of ``n_shards`` ranks each holding its contiguous
        ``ceil(n / n_shards)`` rows (``DeviceDataCache`` on a mesh), the
        counting pass runs over every shard's units, so every rank derives
        the same plan — the same ``perm``, ``class_meta`` and ``n_flat`` — from
        the same whole host columns, and the all-reduce of the permuted
        gradient adds like blocks; only ``shard``'s stacks are filled. With
        ``n_model`` > 1 the plan deals its blocks over the model shards and
        only model shard ``model_index``'s entries are filled."""
        indices = np.asarray(indices, np.int64)
        values = np.asarray(values)
        n = indices.shape[0]
        m = -(-n // n_shards)  # a shard's rows (the cache pads to this)
        local_batch = min(local_batch, m)
        sub = min(sub_rows, local_batch)
        n_sub = -(-local_batch // sub)

        starts, _ = offset_schedule(m, local_batch, max(1, -(-m // local_batch)))
        window_starts = list(dict.fromkeys(int(s) for s in starts))
        n_windows = len(window_starts)

        nblk = -(-dim // BLOCK)
        validate_indices(indices, dim)

        # Pass 1 (counting): per-block max entry count over every unit of
        # every shard.
        max_count = np.zeros(nblk, np.int64)
        bounds = {}
        for s in range(n_shards):
            lo_s = s * m
            for w0 in window_starts:
                for b0 in range(0, local_batch, sub):
                    r0 = lo_s + w0 + b0
                    r1 = min(r0 + sub, lo_s + min(w0 + local_batch, m), n)
                    np.maximum(max_count, block_counts(indices[r0:r1], values[r0:r1], nblk), out=max_count)
                    if s == shard:
                        bounds[w0, b0] = (r0, r1)

        plan = OneHotSparsePlan.from_max_counts(max_count, dim, sub, n_model)
        # one rank's share: a model shard of one data shard
        if max_stack_bytes is not None and plan.stack_bytes(n_windows * n_sub) // n_model > max_stack_bytes:
            return None

        shape = (n_windows, n_sub, plan.n_flat)
        lidx = np.zeros(shape, np.int8)
        rowid = np.zeros(shape, np.int16)
        lvals = np.zeros(shape, np.float32 if values.dtype.kind == "f" else values.dtype)
        for wi, w0 in enumerate(window_starts):
            for bi in range(n_sub):
                r0, r1 = bounds[w0, bi * sub]
                plan.fill_unit(indices[r0:r1], values[r0:r1], lidx[wi, bi], rowid[wi, bi], lvals[wi, bi],
                               model_index)

        return cls(
            plan=plan, dim=int(dim), n_windows=n_windows, n_sub=n_sub,
            n_flat=plan.n_flat, nblk=nblk, n_model=int(n_model), class_meta=plan.class_meta,
            perm=plan.perm, inv_perm=plan.inv_perm, lidx=lidx, rowid=rowid,
            lvals=lvals, window_starts=window_starts, local_batch=local_batch,
            sub_batch=sub,
        )

    @property
    def row_hi(self) -> int:
        return self.plan.row_hi

    @property
    def nblk_local(self) -> int:
        """One model shard's block count (``nblk`` when ``n_model == 1``)."""
        return self.plan.nblk_local

    def permute_coef(self, coef: np.ndarray) -> np.ndarray:
        return self.plan.permute_coef(coef)

    def unpermute_coef(self, coef_perm: np.ndarray) -> np.ndarray:
        return self.plan.unpermute_coef(coef_perm)

    def __repr__(self) -> str:
        return (
            f"OneHotSparseLayout(dim={self.dim}, windows={self.n_windows}, "
            f"sub={self.n_sub}x{self.sub_batch}, flat={self.n_flat}, "
            f"classes={[(f, w) for f, w, _, _ in self.class_meta]})"
        )


# ---------------------------------------------------------------------------
# Feature side: plain torch
# ---------------------------------------------------------------------------


def _slot_blocks(class_meta, device) -> torch.Tensor:
    """Class-major block index of every flat slot ([n_flat] int64)."""
    return torch.cat([
        torch.arange(f_c * wdt, device=device) // wdt + b0
        for f_c, wdt, _off, b0 in class_meta
    ])


def gather_round(coef_perm: torch.Tensor, lidx: torch.Tensor, class_meta) -> torch.Tensor:
    """Per-slot coefficient read, ``g[s, e] = coef_perm[block(e)*128 +
    lidx[s, e]]`` ([n_sub, n_flat]). The JAX package sums a lane one-hot
    against the class's rows to avoid a TPU gather; on the GPU the gather
    is exact indexing."""
    flat = _slot_blocks(class_meta, lidx.device) * BLOCK + lidx.long()
    return coef_perm[flat]


def scatter_round(u: torch.Tensor, lidx: torch.Tensor, class_meta, nblk: int) -> torch.Tensor:
    """Slot values summed into the permuted gradient ``[nblk * 128]``
    across every sub-batch. The JAX package's broadcast-sum form (each
    slot's value placed in its lane, summed over sub-batches and slots),
    chunked over blocks so no product exceeds ``_SCATTER_CHUNK_ELEMS``: a
    torch reduction over fixed axes, so the result is deterministic on the
    card (an index add would use atomics)."""
    n_sub = u.shape[0]
    c2 = torch.zeros(nblk, BLOCK, dtype=u.dtype, device=u.device)
    lanes = torch.arange(BLOCK, dtype=lidx.dtype, device=u.device)
    for f_c, wdt, off, b0 in class_meta:
        ids = lidx[:, off:off + f_c * wdt].reshape(n_sub, f_c, wdt)
        vals = u[:, off:off + f_c * wdt].reshape(n_sub, f_c, wdt)
        step = max(1, _SCATTER_CHUNK_ELEMS // (n_sub * wdt * BLOCK))
        for f0 in range(0, f_c, step):
            f1 = min(f_c, f0 + step)
            hit = ids[:, f0:f1, :, None] == lanes
            c2[b0 + f0:b0 + f1] = torch.where(hit, vals[:, f0:f1, :, None], 0.0).sum(dim=(0, 2))
    return c2.reshape(-1)


# ---------------------------------------------------------------------------
# Row side: the crossings
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 (nearest even), kept as f32."""
    return x.to(torch.bfloat16).float()


def _split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 pair (as f32) with hi + lo == x to ~2^-16."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _premat_tile(n: int, row_hi: int) -> int:
    """The JAX package's premat tile policy; it fixes the padded entry axis
    of the materialised one-hots, which the port keeps so shapes agree."""
    return min(_TILE if row_hi >= 64 else _TILE // 2, max(n, 1))


def _premat_pad(n: int, row_hi: int) -> int:
    t = _premat_tile(n, row_hi)
    return -(-n // t) * t


def premat_bytes(n_units: int, n_flat: int, row_hi: int) -> int:
    """Bytes of the materialised bf16 row one-hots for ``n_units`` units of
    ``n_flat`` entries."""
    return 2 * n_units * _premat_pad(n_flat, row_hi) * (row_hi + _ROW_LO)


def premat_row_onehots(rowid: torch.Tensor, row_hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed rowid stacks ``[..., n]`` int16 -> bf16 row one-hots
    ``(oh_hi [..., n_pad, row_hi], oh_lo [..., n_pad, 128])`` for ``r =
    h·128 + l``; the entry axis padded with all-zero rows. A row id outside
    ``[0, row_hi·128)`` gets an all-zero ``oh_hi`` row, as in the JAX form."""
    n = rowid.shape[-1]
    n_pad = _premat_pad(n, row_hi)
    lead = tuple(rowid.shape[:-1])
    rid = rowid.long()
    hi, lo = rid // _ROW_LO, rid % _ROW_LO
    oh_hi = torch.zeros(lead + (n_pad, row_hi), dtype=torch.bfloat16, device=rowid.device)
    oh_lo = torch.zeros(lead + (n_pad, _ROW_LO), dtype=torch.bfloat16, device=rowid.device)
    hit = ((hi >= 0) & (hi < row_hi)).to(torch.bfloat16)
    oh_hi[..., :n, :].scatter_(-1, hi.clamp(0, row_hi - 1).unsqueeze(-1), hit.unsqueeze(-1))
    oh_lo[..., :n, :].scatter_(-1, lo.unsqueeze(-1), torch.ones_like(hit).unsqueeze(-1))
    return oh_hi, oh_lo


def row_order(rowid: torch.Tensor, row_hi: int, live: Optional[torch.Tensor] = None):
    """The row-sorted entry order the build-form dot kernel walks:
    ``(row_ptr [..., R + 1] int32, entry_of [..., n] int32)`` with ``R =
    row_hi·128``; the entries of row ``r`` are ``entry_of[row_ptr[r]:
    row_ptr[r + 1]]`` in ascending order. Entries with a row id outside
    ``[0, R)`` or (with ``live``) not live are left out: they add nothing to
    any row (padding slots carry value 0, so q is ±0 there). Built once per
    layout, from static stacks."""
    rows = row_hi * _ROW_LO
    key = rowid.long()
    drop = (key < 0) | (key >= rows)
    if live is not None:
        drop |= ~live
    key = torch.where(drop, torch.full_like(key, rows), key)
    sorted_key, entry_of = torch.sort(key, dim=-1, stable=True)
    bounds = torch.arange(rows + 1, device=key.device).expand(key.shape[:-1] + (rows + 1,))
    row_ptr = torch.searchsorted(sorted_key, bounds.contiguous())
    return row_ptr.to(torch.int32), entry_of.to(torch.int32)


def _window(oh_hi, oh_lo, wi):
    if oh_hi.dim() == 4:
        return oh_hi[wi], oh_lo[wi]
    return oh_hi, oh_lo


def dot_crossing_premat_plain(q, oh_hi, oh_lo, wi: int = 0):
    """``dot3[s, h, l] = Σ_e oh_hi[e, h]·bf16(oh_lo[e, l]·q_half[e])`` over
    both split halves, f32 accumulation (the JAX ``dot_crossing_premat_xla``
    form). ``q`` [n_sub, n ≤ n_pad]."""
    oh_hi, oh_lo = _window(oh_hi, oh_lo, wi)
    n_pad = oh_hi.shape[1]
    if q.shape[1] < n_pad:
        q = F.pad(q, (0, n_pad - q.shape[1]))
    q_hi, q_lo = _split_bf16(q)
    hi_t = oh_hi.float().transpose(1, 2)
    lo = oh_lo.float()
    return torch.bmm(hi_t, _bf16(lo * q_hi[..., None])) + torch.bmm(hi_t, _bf16(lo * q_lo[..., None]))


def mult_crossing_premat_plain(mult3, oh_hi, oh_lo, wi: int = 0):
    """``u[s, e] = Σ_l oh_lo[e, l]·(oh_hi[e]·m_hi + oh_hi[e]·m_lo)[l]``
    ([n_sub, n_pad], the JAX ``mult_crossing_premat_xla`` form)."""
    oh_hi, oh_lo = _window(oh_hi, oh_lo, wi)
    m_hi, m_lo = _split_bf16(mult3)
    hi = oh_hi.float()
    rowvecs = torch.bmm(hi, m_hi) + torch.bmm(hi, m_lo)
    return torch.sum(rowvecs * oh_lo.float(), dim=2)


def dot_crossing_plain(q, rowid, row_hi: int):
    """Row sums per sub-batch, ``dot3[s, h, l] = Σ q[s, e]`` over entries
    with row ``h·128 + l`` ([n_sub, row_hi, 128]): the JAX
    ``dot_crossing_xla`` form, with the one-hots built here exactly as
    :func:`premat_row_onehots` builds them, so it equals the premat plain
    version bit for bit."""
    return dot_crossing_premat_plain(q, *premat_row_onehots(rowid, row_hi))


def mult_crossing_plain(mult3, rowid):
    """``u[s, e] = mult3[s, h, l]`` through split-bf16 halves ([n_sub, n]):
    the JAX ``mult_crossing_xla`` form."""
    n = rowid.shape[-1]
    return mult_crossing_premat_plain(mult3, *premat_row_onehots(rowid, mult3.shape[1]))[:, :n]


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda(name: str, t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA; raise otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} needs CPU or CUDA tensors, got {t.device}")
    return False


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dot_crossing(q, rowid, row_hi: int, order=None):
    """Build-form dot crossing ([n_sub, row_hi, 128]). CPU tensors run
    :func:`dot_crossing_plain`; CUDA tensors launch the kernel, walking
    ``order`` (:func:`row_order` of ``rowid``, computed here when None)."""
    if _cuda(DOT_CROSSING.name, q):
        return dot_crossing_plain(q, rowid, row_hi)
    n_sub, n = (int(s) for s in q.shape)
    rows = row_hi * _ROW_LO
    dev = q.device
    if order is None:
        _check("rowid", rowid, torch.int16, (n_sub, n), dev)
        order = row_order(rowid, row_hi)
    row_ptr, entry_of = order
    _check("q", q, torch.float32, (n_sub, n), dev)
    _check("row_ptr", row_ptr, torch.int32, (n_sub, rows + 1), dev)
    _check("entry_of", entry_of, torch.int32, (n_sub, n), dev)
    out = torch.empty((n_sub, row_hi, _ROW_LO), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        DOT_CROSSING.launch(
            q.data_ptr(), row_ptr.data_ptr(), entry_of.data_ptr(), out.data_ptr(),
            n_sub, n, row_hi, DOT_CHUNK, _stream(dev),
        )
    return out


def mult_crossing(mult3, rowid):
    """Build-form mult crossing ([n_sub, n]). CPU tensors run
    :func:`mult_crossing_plain`; CUDA tensors launch the kernel."""
    if _cuda(MULT_CROSSING.name, mult3):
        return mult_crossing_plain(mult3, rowid)
    n_sub, row_hi, _ = (int(s) for s in mult3.shape)
    n = int(rowid.shape[-1])
    dev = mult3.device
    _check("mult3", mult3, torch.float32, (n_sub, row_hi, _ROW_LO), dev)
    _check("rowid", rowid, torch.int16, (n_sub, n), dev)
    out = torch.empty((n_sub, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        MULT_CROSSING.launch(
            mult3.data_ptr(), rowid.data_ptr(), out.data_ptr(), n_sub, n, row_hi, _stream(dev),
        )
    return out


def _premat_shapes(oh_hi, oh_lo, wi: int, dev):
    if oh_hi.dim() == 3:
        oh_hi, oh_lo = oh_hi[None], oh_lo[None]
    n_win, n_sub, n_pad, row_hi = (int(s) for s in oh_hi.shape)
    _check("oh_hi", oh_hi, torch.bfloat16, (n_win, n_sub, n_pad, row_hi), dev)
    _check("oh_lo", oh_lo, torch.bfloat16, (n_win, n_sub, n_pad, _ROW_LO), dev)
    if not 0 <= wi < n_win:
        raise ValueError(f"window {wi} out of range [0, {n_win})")
    if oh_hi.data_ptr() % 16 or oh_lo.data_ptr() % 16:
        raise ValueError("one-hot stacks must be 16-byte aligned")
    return oh_hi, oh_lo, n_sub, n_pad, row_hi


def dot_crossing_premat(q, oh_hi, oh_lo, wi: int = 0):
    """Premat dot crossing ([n_sub, row_hi, 128]) from the materialised
    one-hots (``[n_win, n_sub, n_pad, ·]`` or without the window axis);
    window ``wi`` is selected by pointer offset inside the kernel, never
    copied. CPU tensors run :func:`dot_crossing_premat_plain`."""
    if _cuda(DOT_CROSSING_PREMAT.name, q):
        return dot_crossing_premat_plain(q, oh_hi, oh_lo, wi)
    dev = q.device
    oh_hi, oh_lo, n_sub, n_pad, row_hi = _premat_shapes(oh_hi, oh_lo, wi, dev)
    n = int(q.shape[-1])
    if n > n_pad:
        raise ValueError(f"q has {n} entries, more than the one-hots' {n_pad}")
    _check("q", q, torch.float32, (n_sub, n), dev)
    n_chunks = -(-n_pad // DOT_CHUNK)
    partial = torch.empty((n_sub, n_chunks, row_hi, _ROW_LO), dtype=torch.float32, device=dev)
    out = torch.empty((n_sub, row_hi, _ROW_LO), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        DOT_CROSSING_PREMAT.launch(
            q.data_ptr(), oh_hi.data_ptr(), oh_lo.data_ptr(), partial.data_ptr(),
            out.data_ptr(), wi, n_sub, n, n_pad, row_hi, DOT_CHUNK, n_chunks, _stream(dev),
        )
    return out


def mult_crossing_premat(mult3, oh_hi, oh_lo, wi: int = 0):
    """Premat mult crossing ([n_sub, n_pad]; the caller slices to its n).
    CPU tensors run :func:`mult_crossing_premat_plain`."""
    if _cuda(MULT_CROSSING_PREMAT.name, mult3):
        return mult_crossing_premat_plain(mult3, oh_hi, oh_lo, wi)
    dev = mult3.device
    oh_hi, oh_lo, n_sub, n_pad, row_hi = _premat_shapes(oh_hi, oh_lo, wi, dev)
    _check("mult3", mult3, torch.float32, (n_sub, row_hi, _ROW_LO), dev)
    out = torch.empty((n_sub, n_pad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        MULT_CROSSING_PREMAT.launch(
            mult3.data_ptr(), oh_hi.data_ptr(), oh_lo.data_ptr(), out.data_ptr(),
            wi, n_sub, n_pad, row_hi, _stream(dev),
        )
    return out


def onehot_batch_step(
    coef_perm,
    lidx_w,
    rowid_w,
    lvals_w,
    yb,
    wb,
    loss_func,
    class_meta,
    nblk: int,
    sub_batch: int,
    row_hi: int,
    premat=None,
    order=None,
    model_ctx=None,
):
    """One full minibatch: per-sub-batch forward + crossings + backward,
    gradients accumulated, returning ``(grad_perm, loss_sum, weight_sum)``
    with the scatter path's batch semantics.

    ``lidx_w/rowid_w/lvals_w``: this window's ``[n_sub, n_flat]`` stacks.
    ``yb/wb``: the window's label/weight rows padded to ``n_sub·sub_batch``
    (``wb`` carries mask and tail gating). ``premat``: ``(oh_hi, oh_lo, wi)``
    — the run's materialised one-hots and this minibatch's window — runs
    the premat crossings; otherwise the build-form crossings run, the dot
    walking ``order`` (this window's :func:`row_order`).

    Under tensor parallelism the stacks are this model shard's and ``nblk``
    its local block count; ``model_ctx`` is the mesh whose model axis the
    partial row dots are all-reduced over before the loss (JAX
    ``model_axis``), after which the multiplier is the same on every shard
    and the gradient stays block-local."""
    n_sub, n_flat = (int(s) for s in lidx_w.shape)
    g = gather_round(coef_perm, lidx_w, class_meta)
    q = lvals_w * g
    if premat is not None:
        oh_hi, oh_lo, wi = premat
        dot3 = dot_crossing_premat(q, oh_hi, oh_lo, wi)
    else:
        dot3 = dot_crossing(q, rowid_w, row_hi, order)
    if model_ctx is not None and model_ctx.n_model > 1:
        from flink_ml_tpu_torch.parallel.collectives import all_reduce_tensor

        dot3 = all_reduce_tensor(dot3, model_ctx, "model")
    dot = dot3.reshape(n_sub, row_hi * _ROW_LO)[:, :sub_batch].reshape(-1)
    loss_sum, mult = loss_func.loss_and_mult(dot, yb, wb)
    mult3 = F.pad(mult.reshape(n_sub, sub_batch), (0, row_hi * _ROW_LO - sub_batch))
    mult3 = mult3.reshape(n_sub, row_hi, _ROW_LO)
    if premat is not None:
        back = mult_crossing_premat(mult3, oh_hi, oh_lo, wi)[:, :n_flat]
    else:
        back = mult_crossing(mult3, rowid_w)
    u = lvals_w * back
    grad = scatter_round(u, lidx_w, class_meta, nblk)
    return grad, loss_sum, torch.sum(wb)
