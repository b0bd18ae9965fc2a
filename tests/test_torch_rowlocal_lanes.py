"""The mapping of rows to lanes in the row-local table kernel
(``csrc/megakernel_rowlocal.cu``) and the scale → kmeans kernel
(``csrc/megakernel_scale_kmeans.cu``), and their shared closest-centroid
search (``csrc/rowlocal_ops.cuh``), on the CPU. A CUDA kernel does not run
on the CPU, so this file holds a numpy emulation of what the lanes do:

- the persistent row walk: warps take tasks of rows, strided over the grid;
- lanes per row: the next power of two at or above the table's widest slot
  when that is at most 16, else 32 (``kLanes``), and the registers a lane
  holds (``kSlots``); the scale → kmeans kernel's rows a task;
- a row's sums (normalize's, the logistic margin, |h|^2) as lane partials
  closed by a butterfly over the row's lanes, against the 32-lane butterfly
  of a warp per row;
- the search: one lane forming a centroid's whole distance from 32 partial
  sums closed in the butterfly's tree, against 32 lanes each holding one
  partial and shuffling them together; then the (value, index) butterfly
  of ``kmeans_before`` against a first-minimum scan.

Every operation is one correctly rounded float32 operation in a fixed
order. numpy has no fused multiply-add, so ``fmaf`` below computes the
exact product in float64 (24 + 24 bits fit its 53), adds with the sum's
exact error (TwoSum) and rounds to odd before the one rounding to float32:
that is the correctly rounded fmaf, bit for bit, so no case here is held to
a looser rule. The emulation is held against the port's plain versions and
the JAX package's ``kmeans_assign_fn`` / ``normalize_fn`` under the rules
``chip_smoke.py`` uses (``KMEANS_MARGIN``, ``ULP_ENVELOPE``); the kernels
themselves are held against the plain versions on the card in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.ops.kernels as jk
import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

# Small shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

WARP = 32
TABLE_WARPS = 8  # megakernel_rowlocal.cu kWarps: the dense table kernel's warps a block
SMS = 132  # an H100's SMs
KMEANS_MARGIN = 1e-4  # chip_smoke.py: predictions compared past this float64 top-two gap
MEASURES = ("euclidean", "manhattan", "cosine")
F32 = np.float32


# ---------------------------------------------------------------------------
# float32 arithmetic
# ---------------------------------------------------------------------------


def fmaf(a, b, c):
    """a * b + c rounded once to float32 (``__fmaf_rn``), elementwise."""
    a, b, c = (np.asarray(v, F32).astype(np.float64) for v in (a, b, c))
    a, b, c = np.broadcast_arrays(a, b, c)
    p = a * b  # exact
    s = p + c
    with np.errstate(invalid="ignore"):
        bb = s - p
        err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly (TwoSum)
        inexact = np.isfinite(s) & (err != 0)
        # round to odd: the exact value truncated toward zero, its last bit set
        toward_zero = np.where(np.sign(err) == np.sign(s), s, np.nextafter(s, 0.0))
    odd = (toward_zero.view(np.int64) | 1).view(np.float64)
    return np.where(inexact, odd, s).astype(F32)


def fadd(a, b):
    return (np.asarray(a, F32) + np.asarray(b, F32)).astype(F32)


def butterfly(partials, lanes):
    """A butterfly over `lanes` lanes (the last axis): each step adds lane
    l ^ offset's value to lane l's, offsets lanes / 2 ... 1. Returns lane
    0's total (every lane ends with the same bits)."""
    v = np.array(partials, F32)
    idx = np.arange(lanes)
    off = lanes // 2
    while off:
        v = fadd(v, v[..., idx ^ off])
        off //= 2
    return v[..., 0]


def close32(partials):
    """One lane's 32 partials closed in the butterfly's tree: t += t + 16,
    then + 8, 4, 2, 1 (rowlocal_ops.cuh close32)."""
    acc = np.array(partials, F32)
    off = WARP // 2
    while off:
        acc[..., :off] = fadd(acc[..., :off], acc[..., off:2 * off])
        off //= 2
    return acc[..., 0]


def lane_partials(h, c, d, slots, l1=False):
    """The 32 partials of a row against one vector, a warp per row: partial
    t sums the terms j = t, t + 32, ... for s < slots (a term past d is the
    kernels' zero against zero). h [..., ≥ d], c [..., ≥ d] broadcast."""
    shape = np.broadcast_shapes(h.shape[:-1], c.shape[:-1])
    acc = np.zeros(shape + (WARP,), F32)
    for s in range(slots):
        j = s * WARP + np.arange(WARP)
        inside = j < d
        jj = np.minimum(j, d - 1)
        hv = np.where(inside, h[..., jj], F32(0))
        cv = np.where(inside, c[..., jj], F32(0))
        if l1:
            acc = fadd(acc, np.abs(hv - cv).astype(F32))
        else:
            acc = fmaf(hv, cv, acc)
    return acc


def slots_for(width):
    """kSlots: a lane's registers of a row of `width` at 32 lanes a row."""
    need = -(-width // WARP)
    return 1 << (need - 1).bit_length()


# ---------------------------------------------------------------------------
# the mapping
# ---------------------------------------------------------------------------


def lanes_for(widest):
    """(kLanes, kSlots) of the dense table kernel for its widest slot
    (megakernel_rowlocal.cu launch)."""
    if widest <= 16:
        return 1 << (widest - 1).bit_length(), 1
    return WARP, slots_for(widest)


def kmeans_rows_a_task(slots, k):
    """R of the scale → kmeans kernel: 32 over the next power of two at or
    above k, at most kRowsMax(slots) (megakernel_scale_kmeans.cu plan_layout)."""
    lanes = 1
    while lanes < k and lanes < WARP:
        lanes *= 2
    rows_max = 1 if slots >= 8 else 8 // slots
    return min(WARP // lanes, rows_max)


def kmeans_warps(slots):
    """kWarpsFor of the scale → kmeans kernel: 16 warps a block, 8 at 32
    slots a lane (megakernel_scale_kmeans.cu)."""
    return 8 if slots >= 32 else 16


def walk(rows, rows_a_task, blocks_a_sm, warps):
    """The rows each (block, warp) takes on a persistent grid of blocks of
    `warps` warps, task by task: the grid is min(the tasks' blocks, SMS x
    blocks_a_sm); warp w of block b takes tasks b * warps + w, then that
    plus the grid's warps, ..."""
    tasks = -(-rows // rows_a_task)
    grid = min(-(-tasks // warps), SMS * blocks_a_sm)
    taken = []
    for b in range(grid):
        for w in range(warps):
            for task in range(b * warps + w, tasks, grid * warps):
                taken.extend(r for r in range(task * rows_a_task, (task + 1) * rows_a_task) if r < rows)
    return grid, taken


# each kernel's warps a block: the table kernel's 8 (fewer only where its
# shared memory needs it), the kmeans kernel's 16 (8 at 32 slots)
@pytest.mark.parametrize("warps", (TABLE_WARPS, kmeans_warps(4), kmeans_warps(32)),
                         ids=("table", "kmeans", "kmeans_32_slots"))
@pytest.mark.parametrize("rows_a_task", (1, 2, 4, 8, 32))
@pytest.mark.parametrize("rows", (0, 1, 31, 33, 4099, "past"))
def test_the_persistent_walk_takes_every_row_once(rows, rows_a_task, warps):
    blocks_a_sm = 2
    if rows == "past":  # past one pass of the grid: warps take a second task
        rows = SMS * blocks_a_sm * warps * rows_a_task * 2 + 5
    grid, taken = walk(rows, rows_a_task, blocks_a_sm, warps)
    assert sorted(taken) == list(range(rows))
    assert grid <= SMS * blocks_a_sm


@pytest.mark.parametrize("width", (1, 2, 3, 7, 8, 16, 17, 32, 33, 100, 1024))
def test_lanes_a_row_follow_the_widest_slot(width):
    lanes, slots = lanes_for(width)
    assert lanes & (lanes - 1) == 0 and lanes <= WARP and lanes >= min(width, WARP)
    assert lanes * slots >= width and (slots == 1 or lanes == WARP)
    assert width > 16 or lanes < 2 * width  # the next power of two: at most half the lanes idle
    # lane i of group g holds elements i, i + lanes, ...: each element of
    # each of the warp's 32 / lanes rows once, in its row's group
    held = {}
    for lane in range(WARP):
        g, i = divmod(lane, lanes)
        for s in range(slots):
            j = s * lanes + i
            if j < width:
                held.setdefault((g, j), []).append(lane)
    assert sorted(held) == [(g, j) for g in range(WARP // lanes) for j in range(width)]
    assert all(len(v) == 1 for v in held.values())
    # the kmeans strip: the row's terms zero-padded to 32 a step, the stride
    # 4 mod 8; at 32 lanes the lanes' writes cover the padded row
    pad = -(-width // WARP) * WARP
    assert (pad + 4) % 8 == 4 and pad >= width
    assert lanes < WARP or slots * lanes >= pad


@pytest.mark.parametrize("d", (1, 7, 100, 256, 1024))
@pytest.mark.parametrize("k", (1, 2, 10, 33, 1024))
def test_the_kmeans_kernels_rows_a_task_fit_a_lanes_registers(d, k):
    slots = slots_for(d)
    R = kmeans_rows_a_task(slots, k)
    lanes = WARP // R
    assert R >= 1 and R * slots <= max(8, slots)
    assert lanes >= min(k, WARP) or R == (1 if slots >= 8 else 8 // slots)
    if (d, k) == (100, 10):
        assert (R, lanes) == (2, 16)


# ---------------------------------------------------------------------------
# sums over a row's lanes
# ---------------------------------------------------------------------------


def _rows(rng, n, w):
    x = rng.standard_normal((n, w)).astype(F32)
    x[0] = 0.0
    x[1, w // 2] = np.nan
    x[2, 0] = np.inf
    x[3] *= F32(1e-30)  # products that round toward zero
    return x


def _pow_p(t, p):
    if p == 1.0:
        return t
    if p == 2.0:
        return (t * t).astype(F32)
    return ((t * t).astype(F32) * t).astype(F32)


def _normalize_sum_warp(x, p, slots):
    """A warp per row: lane l's partial adds |x_j|^p for j = l, l + 32, ..."""
    w = x.shape[1]
    acc = np.zeros((x.shape[0], WARP), F32)
    for s in range(slots):
        j = s * WARP + np.arange(WARP)
        term = _pow_p(np.abs(x[:, np.minimum(j, w - 1)]), p)
        acc = np.where(j < w, fadd(acc, term), acc)
    return butterfly(acc, WARP)


def _normalize_sum_lanes(x, p, lanes, slots):
    """kLanes lanes a row: lane i's partial adds |x_j|^p for j = i, i +
    kLanes, ..., closed over the row's lanes."""
    w = x.shape[1]
    acc = np.zeros((x.shape[0], lanes), F32)
    for s in range(slots):
        j = s * lanes + np.arange(lanes)
        term = _pow_p(np.abs(x[:, np.minimum(j, w - 1)]), p)
        acc = np.where(j < w, fadd(acc, term), acc)
    return butterfly(acc, lanes)


def _margin_warp(x, coef, slots):
    w = x.shape[1]
    acc = np.zeros((x.shape[0], WARP), F32)
    for s in range(slots):
        j = s * WARP + np.arange(WARP)
        jj = np.minimum(j, w - 1)
        acc = np.where(j < w, fmaf(x[:, jj], coef[jj], acc), acc)
    return butterfly(acc, WARP)


def _margin_lanes(x, coef, lanes, slots):
    w = x.shape[1]
    acc = np.zeros((x.shape[0], lanes), F32)
    for s in range(slots):
        j = s * lanes + np.arange(lanes)
        jj = np.minimum(j, w - 1)
        acc = np.where(j < w, fmaf(x[:, jj], coef[jj], acc), acc)
    return butterfly(acc, lanes)


def _same_bits_or_zero(a, b):
    """Bit-equal, a NaN matching any NaN, ±0 alike (a lane past the width
    adds +0, which changes only the sign of a zero sum)."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    na, nb = np.isnan(a), np.isnan(b)
    same = (a.view(np.int32) == b.view(np.int32)) | (na & nb) | ((a == 0) & (b == 0))
    return bool(same.all())


@pytest.mark.parametrize("width", (1, 2, 3, 7, 8, 16, 17, 32, 33, 100, 1024))
def test_a_rows_lanes_sum_as_a_warps_butterfly(width):
    rng = np.random.default_rng(width)
    x = _rows(rng, 9, width)
    coef = (rng.standard_normal(width) * 3.0 / np.sqrt(width)).astype(F32)
    lanes, slots = lanes_for(width)
    warp_slots = slots_for(width)  # a warp per row holds the same row in these registers
    for p in (1.0, 2.0, 3.0):
        assert _same_bits_or_zero(_normalize_sum_lanes(x, p, lanes, slots), _normalize_sum_warp(x, p, warp_slots))
    assert _same_bits_or_zero(_margin_lanes(x, coef, lanes, slots), _margin_warp(x, coef, warp_slots))


def _normalize_lanes(x, p):
    """normalize as the dense interpreter runs it (rowlocal_ops.cuh run_rows)."""
    lanes, slots = lanes_for(x.shape[1])
    total = _normalize_sum_lanes(x, p, lanes, slots)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        norm = total if p == 1.0 else (np.sqrt(total) if p == 2.0 else np.power(total, F32(1.0 / p)))
        denom = np.where(norm == 0.0, F32(1.0), norm).astype(F32)
        return (x / denom[:, None]).astype(F32)


@pytest.mark.parametrize("width", (1, 2, 7, 16, 17, 100))
@pytest.mark.parametrize("p", (1.0, 2.0, 3.0))
def test_normalize_on_a_rows_lanes_holds_the_plain_and_jax_envelope(width, p):
    rng = np.random.default_rng(10 * width + int(p))
    x = rng.standard_normal((33, width)).astype(F32)
    x[0] = 0.0
    got = _normalize_lanes(x, p)
    plain = tk.normalize_fn(torch.from_numpy(x), p).numpy()
    jax_out = np.asarray(jk.normalize_fn(jnp.asarray(x), p))
    assert ulp_diff(got, plain) <= ULP_ENVELOPE["feature6"]
    assert ulp_diff(got, jax_out) <= ULP_ENVELOPE["feature6"]


# ---------------------------------------------------------------------------
# the closest-centroid search
# ---------------------------------------------------------------------------


def _distances(dots, p2, norms, measure):
    """rowlocal_ops.cuh kmeans_distance on closed sums [rows, k]."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        if measure == "euclidean":
            sq = ((p2[:, None] + norms[None, :]).astype(F32) - (F32(2) * dots).astype(F32)).astype(F32)
            return np.sqrt(np.where(sq < 0, F32(0), sq)).astype(F32)  # NaN < 0 is false: NaN stays
        if measure == "cosine":
            pn = np.sqrt(p2).astype(F32)
            return (F32(1) - ((dots / pn[:, None]).astype(F32) / norms[None, :]).astype(F32)).astype(F32)
        return dots


def _first_minimum(dist):
    """The warp-per-row scan: c = 0 first, then a c replaces the best when
    the best is not NaN and c's distance is NaN or smaller."""
    best = dist[:, 0].copy()
    idx = np.zeros(dist.shape[0], np.int64)
    for c in range(1, dist.shape[1]):
        take = ~np.isnan(best) & (np.isnan(dist[:, c]) | (dist[:, c] < best))
        best = np.where(take, dist[:, c], best)
        idx = np.where(take, c, idx)
    return idx


def _before(a, ia, b, ib):
    """rowlocal_ops.cuh kmeans_before, elementwise."""
    na, nb = np.isnan(a), np.isnan(b)
    with np.errstate(invalid="ignore"):
        numbers = (a < b) | ((a == b) & (ia < ib))
    return np.where(na | nb, na & (~nb | (ia < ib)), numbers)


def _lanes_argmin(dist, lanes):
    """Lane i of a row's `lanes` takes centroids i, i + lanes, ... in order,
    keeping the first by _before (from +inf at index INT_MAX); then the
    (value, index) butterfly over the lanes (rowlocal_ops.cuh group_argmin)."""
    n, k = dist.shape
    best = np.full((n, lanes), np.inf, F32)
    best_idx = np.full((n, lanes), np.iinfo(np.int32).max, np.int64)
    for c in range(k):
        i = c % lanes
        take = _before(dist[:, c], c, best[:, i], best_idx[:, i])
        best[:, i] = np.where(take, dist[:, c], best[:, i])
        best_idx[:, i] = np.where(take, c, best_idx[:, i])
    off = lanes // 2
    lane = np.arange(lanes)
    while off:
        o, oi = best[:, lane ^ off], best_idx[:, lane ^ off]
        take = _before(o, oi, best, best_idx)
        best, best_idx = np.where(take, o, best), np.where(take, oi, best_idx)
        off //= 2
    assert (best_idx == best_idx[:, :1]).all()  # every lane of the row agrees
    return best_idx[:, 0]


def _search(h, C, measure, slots, lanes, one_lane):
    """The index of each row's closest centroid, and the distances.
    one_lane: kmeans_search (each lane a centroid's 32 partials closed in
    the tree; `lanes` lanes over centroids; the (value, index) butterfly);
    else a warp per row (32 lanes each one partial, the butterfly; a
    first-minimum scan)."""
    d = C.shape[1]
    l1 = measure == "manhattan"
    p2 = butterfly(lane_partials(h, h, d, slots), WARP)
    norms = butterfly(lane_partials(C, C, d, slots_for(d)), WARP)
    if measure == "cosine":
        norms = np.sqrt(norms).astype(F32)
    # one lane walks the row's 32-term steps up to d; a warp per row, its kSlots
    steps = -(-d // WARP) if one_lane else slots
    parts = lane_partials(h[:, None, :], C[None, :, :], d, steps, l1)  # [rows, k, 32]
    dots = close32(parts) if one_lane else butterfly(parts, WARP)
    dist = _distances(dots, p2, norms, measure)
    return (_lanes_argmin(dist, lanes) if one_lane else _first_minimum(dist)), dist


def _kmeans_rows(rng, n, d, k):
    h = rng.random((n, d)).astype(F32)
    C = rng.random((k, d)).astype(F32)
    if k >= 3:
        C[k - 1] = C[1]  # a duplicate centroid: the first index wins
        h[0] = C[1]  # its exact tie
    if n >= 4 and k >= 2:
        h[1, d // 2] = np.nan  # NaN everywhere: index 0
        h[2] = 0.0  # cosine: 0 / 0 in every column
        h[3] = (C[0] + C[min(1, k - 1)]) * F32(0.5)  # halfway between two centroids
    return h, C


@pytest.mark.parametrize("d", (1, 7, 31, 32, 33, 100, 257, 1024))
@pytest.mark.parametrize("k", (1, 2, 10, 33, 1024))
def test_one_lane_a_centroid_keeps_the_warps_bits(d, k):
    rng = np.random.default_rng(d * 7919 + k)
    n = 6 if d * k <= 100_000 else 4
    h, C = _kmeans_rows(rng, n, d, k)
    slots = slots_for(d)
    for measure in MEASURES:
        want, dist_old = _search(h, C, measure, 2 * slots, WARP, one_lane=False)  # a wider table's kSlots too
        # the dense table kernel below 32 lanes a row: lanes from the width (at
        # 32 it runs the warp's search, `want`); the scale -> kmeans kernel: from k
        for lanes in {l for l in (lanes_for(d)[0],) if l < WARP} | {WARP // kmeans_rows_a_task(slots, k)}:
            got, dist_new = _search(h, C, measure, slots, lanes, one_lane=True)
            assert _same_bits_or_zero(dist_new, dist_old), (measure, lanes)
            np.testing.assert_array_equal(got, want, err_msg=f"{measure} lanes={lanes}")


def _kmeans_decided(measure, X, C):
    """chip_smoke.py's rule: rows whose float64 top-two distance gap
    exceeds KMEANS_MARGIN, and rows with a NaN distance."""
    X, C = X.astype(np.float64), C.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if measure == "euclidean":
            dist = np.sqrt(((X[:, None, :] - C[None]) ** 2).sum(-1))
        elif measure == "manhattan":
            dist = np.abs(X[:, None, :] - C[None]).sum(-1)
        else:
            dist = 1.0 - (X @ C.T) / np.linalg.norm(X, axis=1)[:, None] / np.linalg.norm(C, axis=1)[None, :]
    nan = np.isnan(dist).any(axis=1)
    if dist.shape[1] < 2:
        return np.ones_like(nan)
    top = np.sort(np.nan_to_num(dist, nan=0.0), axis=1)[:, :2]
    return nan | (top[:, 1] - top[:, 0] > KMEANS_MARGIN)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("d,k", ((7, 10), (16, 10), (100, 10), (256, 64)))
def test_the_search_agrees_with_the_plain_and_jax_assignment(measure, d, k):
    rng = np.random.default_rng(d + k)
    h, C = _kmeans_rows(rng, 40, d, k)
    got, _ = _search(h, C, measure, slots_for(d), WARP // kmeans_rows_a_task(slots_for(d), k), one_lane=True)
    plain = tk.kmeans_assign_fn(measure)(torch.from_numpy(h), torch.from_numpy(C)).numpy()
    jax_idx = np.asarray(jk.kmeans_assign_fn(measure)(jnp.asarray(h), jnp.asarray(C)))
    decided = _kmeans_decided(measure, h, C)
    assert decided.sum() >= 30
    np.testing.assert_array_equal(got[decided], plain[decided])
    np.testing.assert_array_equal(got[decided], jax_idx[decided])
    assert got[1] == plain[1] == jax_idx[1] == 0  # a NaN row


@pytest.mark.parametrize("lanes", (1, 2, 4, 8, 16, 32))
def test_the_value_index_butterfly_takes_the_first_minimum(lanes):
    rng = np.random.default_rng(lanes)
    k = 37
    dist = rng.integers(0, 4, (64, k)).astype(F32)  # many ties
    dist[1:, 5] = np.nan  # a NaN column: it wins, unless an earlier NaN does
    dist[2:, 3] = np.nan
    dist[4] = np.nan  # every distance NaN: index 0
    dist[5] = 7.0  # every distance equal: index 0
    dist[6, ::2] = -0.0  # -0 and +0 tie: the first wins
    dist[6, 1::2] = 0.0
    dist[7] = np.inf
    dist[8, :] = 9.0
    dist[8, k - 1] = 1.0  # the minimum in the last lane's last centroid
    np.testing.assert_array_equal(_lanes_argmin(dist, lanes), _first_minimum(dist))
    for k_small in (1, 2, 3):
        np.testing.assert_array_equal(_lanes_argmin(dist[:, :k_small], lanes), _first_minimum(dist[:, :k_small]))
