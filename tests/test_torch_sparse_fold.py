"""The arithmetic of the tiled sparse serving kernel
(``csrc/megakernel_sparse_idf_logistic.cu``) and of the table's sparse head
(``csrc/rowlocal_ops.cuh``), which share the fold of ``csrc/sparse_fold.cuh``,
on the CPU. A CUDA kernel does not run on the CPU, so this file holds a numpy
emulation of what each lane does: the tile plan (rows a tile, slots a row,
quads a lane, the shared-memory stride), a lane's 16-byte groups of the
tile's flat range, the row and column each product lands on in the tile,
the one-lane-per-row fold in slot order, the sum carried across chunks of a
K past one tile, and the table's fold of 32 products at a time on one lane.
The emulation is held bit for bit against the port's plain versions and, as
values (±0 alike, NaN alike), against the JAX package's ``sparse_dot_fn``
and ``sparse_idf_scale_fn``. Every operation is one correctly rounded
float32 multiply or add in a fixed order, so numpy's float32 gives the
kernel's bits. The kernels themselves are held against the plain versions
on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch.servable.megakernels import (
    ROWLOCAL_MAX_DIM,
    sparse_idf_logistic_plain,
    sparse_idf_plain,
)

# Small shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

WARP = 32
MAX_QUADS = 2  # kMaxQuads
TILE_SLOTS = WARP * MAX_QUADS * 4 - 3  # kTileSlots: 253
SPREAD_TILES = 2  # kSpreadTiles
SMEM_PER_BLOCK = 48 * 1024  # a launch's dynamic shared memory without the opt-in
CAPS = (1, 2, 3, 8, 13, 32, 33, 64, 65, 300, 600)  # 300 and 600: past one tile's 253 slots


def tile_stride(kc):
    """The tile's row stride in floats: whole 16-byte words, an odd count."""
    s = (kc + 3) & ~3
    return s + 4 if (s // 4) % 2 == 0 else s


def tile_plan(rows, K, sms):
    """``(kc, R, quads)`` as the launch picks them on a card of ``sms`` SMs."""
    kc = min(K, TILE_SLOTS)
    R = min(TILE_SLOTS // kc, WARP, -(-rows // (SPREAD_TILES * sms)))
    quads = 1 if R * kc <= 4 * WARP - 3 else MAX_QUADS
    return kc, R, quads


def clamp(ids, d):
    """``sparse_fold::clamp_id``: a negative id counts from the end, then
    it is clipped into [0, d)."""
    i = np.where(ids < 0, ids + d, ids)
    return np.clip(i, 0, d - 1)


def fold(p, n, acc):
    """``sparse_fold::fold`` on many lanes at once: acc + p[:, 0] + ... +
    p[:, n - 1], each add rounded, in slot order (its 16-byte loads take four
    at a time, in the same order)."""
    acc = np.asarray(acc, np.float32).copy()
    for j in range(n):
        acc = (acc + p[:, j]).astype(np.float32)
    return acc


def sparse_kernel(values, ids, idf, coef, sms, with_idf=True, with_head=True):
    """What the kernel's lanes compute: ``(tfidf or None, margin or None)``.
    Quad q of a tile's range is lane q % 32's (its u-th, u = q // 32), so
    arrays over q hold every lane's work."""
    rows, K = values.shape
    d = coef.shape[0] if with_head else idf.shape[0]
    kc, R, quads = tile_plan(rows, K, sms)
    stride = tile_stride(kc)
    flat_v, flat_i = values.reshape(-1), ids.reshape(-1).astype(np.int64)
    tfidf = np.full(rows * K, np.nan, np.float32) if with_idf else None
    margin = np.full(rows, np.nan, np.float32) if with_head else None
    q = np.arange(WARP * quads)
    for row0 in range(0, rows, R):  # one warp a tile
        nr = min(R, rows - row0)
        acc = np.zeros(nr, np.float32)
        for c0 in range(0, K, kc):
            assert c0 == 0 or nr == 1  # the tile is one contiguous range
            w = min(kc, K - c0)
            g0 = row0 * K + c0
            lead = g0 & 3
            end = lead + nr * w
            base = g0 - lead
            i = 4 * q - lead  # each quad's first slot at row r, column c of the tile
            r = np.where(i > 0, i // w, 0)
            c = i - r * w
            prod = np.full((R, stride), np.nan, np.float32)
            written = np.zeros((R, stride), np.int64)
            covered = np.zeros(end, np.int64)
            for j in range(4):
                f = 4 * q + j
                live = (f >= lead) & (f < end)
                np.add.at(covered, f[live], 1)
                g = base + f[live]
                x = flat_v[g]
                k = clamp(flat_i[g], d)
                if with_idf:
                    x = (x * idf[k]).astype(np.float32)
                    tfidf[g] = x
                if with_head:
                    rr, cc = r[live], c[live]
                    assert (cc >= 0).all() and (rr < nr).all() and (cc < w).all()
                    prod[rr, cc] = (x * coef[k]).astype(np.float32)
                    np.add.at(written, (rr, cc), 1)
                c = c + 1  # the next slot: one column on, the next row past the last
                wrap = c == w
                c[wrap], r[wrap] = 0, r[wrap] + 1
            assert (covered[lead:end] == 1).all(), "a slot of the tile taken by no lane or by two"
            if with_head:
                assert (written[:nr, :w] == 1).all() and written.sum() == nr * w
                acc = fold(prod[:nr], w, acc)  # lane r < nr folds row r
        if with_head:
            margin[row0:row0 + nr] = acc
    return (None if tfidf is None else tfidf.reshape(rows, K)), margin


def table_fold(terms):
    """The table's sparse head: the warp's products 32 at a time in its
    strip, lane 0 folding each chunk onto its sum."""
    rows, w = terms.shape
    acc = np.zeros(rows, np.float32)
    for s in range(0, w, WARP):
        n = min(WARP, w - s)
        strip = np.full((rows, WARP), np.nan, np.float32)
        strip[:, :n] = terms[:, s:s + n]
        acc = fold(strip, n, acc)
    return acc


def _inputs(rows, K, d, seed, inf_coef0=False, wild_ids=False):
    """Packed rows shorter than the cap (padding id 0 / value 0), sorted
    ids, the model vectors; optionally coef[0] = inf and ids out of range."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, K + 1, rows)
    ids = np.sort(rng.integers(0, d, (rows, K)), axis=1).astype(np.int32)
    vals = rng.normal(size=(rows, K)).astype(np.float32)
    dead = np.arange(K)[None, :] >= nnz[:, None]
    ids[dead], vals[dead] = 0, 0.0
    if wild_ids:
        wild = np.array([-1, d, -3 * d, d + 7, -2], np.int32)
        ids.reshape(-1)[: min(ids.size, wild.size)] = wild[: ids.size]
    idf = (np.abs(rng.normal(size=d)) + 0.1).astype(np.float32)
    coef = (rng.normal(size=d) * 0.3).astype(np.float32)
    if inf_coef0:
        coef[0] = np.inf
    return vals, ids, idf, coef


def _same_bits(a, b):
    """Bit-equal, a NaN matching any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    return bool((na == nb).all()) and bool((a[~na].view(np.int32) == b[~nb].view(np.int32)).all())


@pytest.mark.parametrize("sms", (1, 4, 132))
def test_tile_plan_covers_every_tile_within_its_limits(sms):
    for rows in (1, 2, 7, 37, 203, 1024, 4099):
        for K in (*CAPS, 125, 126, 252, 253, 254, 1500):
            kc, R, quads = tile_plan(rows, K, sms)
            where = f"rows={rows} K={K} sms={sms}"
            assert 1 <= R <= WARP and R * kc <= TILE_SLOTS, where  # a lane a row folds
            assert kc == K or R == 1, where  # one contiguous range a tile
            assert WARP * quads * 4 >= R * kc + 3, where  # a lane's quads hold it at any alignment
            stride = tile_stride(kc)
            assert stride >= kc and stride % 4 == 0 and (stride // 4) % 2 == 1, where
            assert 4 * R * stride <= SMEM_PER_BLOCK, where
    # the serving shapes of the kernel's comment, on the H100's 132 SMs
    assert tile_plan(4096, 64, 132) == (64, 3, 2) and -(-4096 // 3) == 1366
    assert tile_plan(1024, 16, 132) == (16, 4, 1)
    assert tile_plan(203, 8, 132) == (8, 1, 1)


@jax.jit
def _jax_chain(vals, ids, idf, coef):
    """The JAX package's tf-idf, its margin, and the head alone's margin."""
    tfidf = jk.sparse_idf_scale_fn(vals, ids, idf)
    return tfidf, jk.sparse_dot_fn(tfidf, ids, coef), jk.sparse_dot_fn(vals, ids, coef)


@pytest.mark.parametrize("K", CAPS)
def test_tiled_kernel_is_bit_equal_to_the_plain_versions_and_jax(K):
    """IDF → LR, the head alone and IDF alone, at row counts that are no
    multiple of a tile's rows, with tiles of one row and of many."""
    vals, ids, idf, coef = _inputs(45, K, 1000, seed=K)
    j_tfidf, j_margin, j_head = (np.asarray(a) for a in _jax_chain(*(jnp.asarray(a) for a in (vals, ids, idf, coef))))
    for lo, hi in ((0, 1), (1, 8), (8, 45)):  # 1, 7 and 37 rows
        v, i = vals[lo:hi], ids[lo:hi]
        t = [torch.from_numpy(a) for a in (v, i, idf, coef)]
        p_tfidf, p_margin, _, _ = sparse_idf_logistic_plain(*t)
        _, p_head, _, _ = sparse_idf_logistic_plain(t[0], t[1], None, t[3])
        for sms in (1, 132):  # many rows a tile, then one
            where = f"rows={hi - lo} K={K} sms={sms}"
            tfidf, margin = sparse_kernel(v, i, idf, coef, sms)
            assert _same_bits(tfidf, p_tfidf.numpy()) and _same_bits(margin, p_margin.numpy()), where
            np.testing.assert_array_equal(tfidf, j_tfidf[lo:hi], err_msg=where)
            np.testing.assert_array_equal(margin, j_margin[lo:hi], err_msg=where)
            _, head = sparse_kernel(v, i, None, coef, sms, with_idf=False)
            assert _same_bits(head, p_head.numpy()), where
            np.testing.assert_array_equal(head, j_head[lo:hi], err_msg=where)
            alone, none = sparse_kernel(v, i, idf, None, sms, with_head=False)
            assert none is None and _same_bits(alone, sparse_idf_plain(t[0], t[1], t[2]).numpy()), where


@pytest.mark.parametrize("K", (3, 8, 65, 300))
def test_padding_adds_zero_times_coef0_and_ids_clamp(K):
    """A padding slot adds 0 · coef[0]: NaN when coef[0] is infinite, as in
    the plain version; a negative id counts from the end, then ids clip."""
    d = 100
    vals, ids, idf, coef = _inputs(9, K, d, seed=K, inf_coef0=True, wild_ids=True)
    t = [torch.from_numpy(a) for a in (vals, ids, idf, coef)]
    p_tfidf, p_margin, _, _ = sparse_idf_logistic_plain(*t)
    j_tfidf, j_margin, _ = (np.asarray(a) for a in _jax_chain(*(jnp.asarray(a) for a in (vals, ids, idf, coef))))
    with np.errstate(invalid="ignore"):  # 0 · inf
        for sms in (1, 132):
            tfidf, margin = sparse_kernel(vals, ids, idf, coef, sms)
            assert _same_bits(tfidf, p_tfidf.numpy()) and _same_bits(margin, p_margin.numpy())
    np.testing.assert_array_equal(tfidf, j_tfidf)
    np.testing.assert_array_equal(margin, j_margin)
    assert np.isnan(margin).any()


@pytest.mark.parametrize("cap", (1, 2, 13, 32, 33, 64, 65, ROWLOCAL_MAX_DIM))
def test_table_sparse_head_fold_is_the_sequential_fold(cap):
    """The table's fold of 32 products at a time on lane 0 against the
    plain ``segment_sum`` (bit for bit) and the JAX ``sparse_dot_fn``."""
    vals, ids, _idf, coef = _inputs(5, cap, 2000, seed=cap, inf_coef0=cap % 2 == 1)
    with np.errstate(invalid="ignore"):  # 0 · inf
        terms = (vals * coef[clamp(ids.astype(np.int64), coef.shape[0])]).astype(np.float32)
        got = table_fold(terms)
    want = tk.sparse_dot_fn(torch.from_numpy(vals), torch.from_numpy(ids), torch.from_numpy(coef)).numpy()
    assert _same_bits(got, want)
    np.testing.assert_array_equal(got, np.asarray(jk.sparse_dot_fn(jnp.asarray(vals), jnp.asarray(ids),
                                                                   jnp.asarray(coef))))
