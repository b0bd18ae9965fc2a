"""The build-form crossing kernels' walks, emulated on the CPU.

``csrc/onehot_crossing.cu`` cannot run here, so this file holds a numpy
float32 emulation of its two build-form kernels as they are written, and
holds it against the emulation of the walk they replace, the premat order,
the port's plain versions and the JAX package:

- the dot: rows dealt to warps' tiles of ``DOT_ROWS`` consecutive rows of one
  sub-batch (warp w of block (x, s) takes rows from (x·DOT_WARPS + w)·32);
  a tile's entries one contiguous range of :func:`row_order`'s
  ``entry_of``, its ids staged in pieces of ``DOT_STAGE`` entries that start
  at the 16-byte word holding the range's first entry (16-byte copies where
  a whole word lies inside, 4-byte ones at the ends); lane i then walks row
  r0 + i from the stage, ``DOT_BATCH`` entries at a time (their q gathered
  together, then folded) in today's order (entries ascending, one f32
  accumulator per split half inside each chunk of ``DOT_CHUNK`` entries, the
  halves added at the chunk's end, the chunk sums in order), carrying
  ``(total, acc_hi, acc_lo, chunk)`` from one batch and one piece to the
  next. Bit-equal to the emulation of
  today's thread-per-row walk (``test_torch_crossing_premat.emulate_dot_build``)
  and of the premat kernel's order, and within ``1e-5·Σ_row|q| + 1e-6`` of
  the JAX ``dot_crossing_pallas`` in interpret mode and ``dot_crossing_xla``;
- the mult: per sub-batch, slots before the first 16-byte word of row ids
  (the head) and after the last whole 8-slot group (the tail) one at a
  time, the groups between them eight slots a thread, walked by a
  persistent grid (thread t takes groups t, t + stride, …, ``kMultInFlight``
  of them loaded at a time); each slot's ``bf16(m) + bf16(m − bf16(m))`` of
  its row's ``mult3``, 0 for an id outside ``[0, R)``. Bit-equal to
  ``mult_crossing_plain`` and the JAX ``mult_crossing_xla``.

The tile and group constants are read from the kernel's source, so the
emulation walks what the kernel is built with.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flink_ml_tpu.linalg.onehot_sparse as J
from flink_ml_tpu.config import Options as JOptions, config as jconfig
import flink_ml_tpu_torch.linalg.onehot_sparse as T
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.native import CSRC_DIR
from tests.test_torch_crossing_premat import emulate_dot_build, emulate_dot_premat

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

_SOURCE = (CSRC_DIR / "onehot_crossing.cu").read_text()


def _constexpr(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\w+);", _SOURCE)
    assert m, name
    return 32 if m.group(1) == "kWarp" else int(m.group(1))


WARP = _constexpr("kWarp")
DOT_ROWS, DOT_WARPS, DOT_STAGE, DOT_BATCH = (
    _constexpr(k) for k in ("kDotRows", "kDotWarps", "kDotStage", "kDotBatch"))
MULT_THREADS, MULT_IN_FLIGHT = _constexpr("kMultBuildThreads"), _constexpr("kMultInFlight")


@pytest.fixture(autouse=True)
def _unset_config():
    """Every option set while a test here runs is unset after it: the test
    workers run other files in the same process."""
    before = (dict(config._values), dict(jconfig._values))
    yield
    for opts, conf, kept in ((Options, config, before[0]), (JOptions, jconfig, before[1])):
        for key, option in opts.all().items():
            if key not in kept:
                conf.unset(option)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest-even bf16, kept as float32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


# ---------------------------------------------------------------------------
# the dot
# ---------------------------------------------------------------------------


def stage_plan(lo: int, hi: int):
    """The copies ``stage_ids`` issues for stage positions [lo, hi), lane by
    lane: ``(lane, position, bytes)``. Positions are 16-byte words of the
    stage from ``lo & ~3``; a word wholly inside takes one 16-byte copy."""
    plan = []
    for lane in range(WARP):
        for p in range((lo & ~3) + 4 * lane, hi, 4 * WARP):
            if p >= lo and p + 4 <= hi:
                plan.append((lane, p, 16))
            else:
                plan.extend((lane, j, 4) for j in range(max(p, lo), min(p + 4, hi)))
    return plan


def piece_starts(b: int, e: int, mis: int):
    """The first entry index g0 of each piece of a tile's range [b, e), for
    ``entry_of``'s sub-batch row ``mis`` words past a 16-byte boundary."""
    return list(range(((b + mis) & ~3) - mis, e, DOT_STAGE))


def emulate_dot_tiles(q, row_ptr, entry_of, row_hi, eo_word=0, chunk=T.DOT_CHUNK):
    """The build-form dot kernel, tile by tile ([n_sub, row_hi, 128]).
    ``eo_word``: ``entry_of``'s first element, in words past a 16-byte
    boundary (a window's view sits anywhere)."""
    q = np.asarray(q, np.float32)
    n_sub, n = q.shape
    rows = row_hi * 128
    shift = chunk.bit_length() - 1
    assert 1 << shift == chunk
    out = np.full((n_sub, rows), np.nan, np.float32)
    written = np.zeros((n_sub, rows), np.int64)
    tiles = rows // DOT_ROWS
    r0s = np.array([(bx * DOT_WARPS + w) * DOT_ROWS for bx in range(-(-tiles // DOT_WARPS))
                    for w in range(DOT_WARPS)])
    r0s = r0s[r0s < rows]  # a warp past the rows returns
    for s in range(n_sub):
        mis = (eo_word + s * n) & 3
        rs = row_ptr[s, r0s[:, None] + np.arange(DOT_ROWS)].astype(np.int64)  # [tiles, lanes]
        re_ = row_ptr[s, r0s[:, None] + np.arange(DOT_ROWS) + 1].astype(np.int64)
        b, e = rs[:, 0], re_[:, -1]
        total = np.zeros(rs.shape, np.float32)
        acc_hi = np.zeros(rs.shape, np.float32)
        acc_lo = np.zeros(rs.shape, np.float32)
        cur = np.full(rs.shape, -1, np.int64)
        g0 = ((b + mis) & ~3) - mis
        while True:
            live = g0 < e
            if not live.any():
                break
            lo = np.maximum(b - g0, 0)
            hi = np.minimum(e - g0, DOT_STAGE)
            a = np.maximum(rs - g0[:, None], lo[:, None])
            z = np.minimum(re_ - g0[:, None], hi[:, None])
            t = np.flatnonzero(live & ((z - a).max(axis=1) > 0))  # tiles with a lane to fold
            a, z, base = a[t], z[t], g0[t, None]
            st = [total[t], acc_hi[t], acc_lo[t], cur[t]]
            # a lane's batches of DOT_BATCH entries keep its order: step k is
            # entry k of the lane's part of this piece
            for k in range((z - a).max(initial=0)):
                on = a + k < z
                ids = entry_of[s, np.where(on, base + a + k, 0)].astype(np.int64)
                x = np.where(on, q[s, ids], np.float32(0))
                c = ids >> shift
                new = on & (c != st[3])
                close = new & (st[3] >= 0)
                st[0] = np.where(close, st[0] + (st[1] + st[2]), st[0])
                st[1] = np.where(new, np.float32(0), st[1])
                st[2] = np.where(new, np.float32(0), st[2])
                st[3] = np.where(new, c, st[3])
                xh = _bf16(x)
                xl = _bf16(x - xh)
                st[1] = np.where(on, st[1] + xh, st[1])
                st[2] = np.where(on, st[2] + xl, st[2])
            total[t], acc_hi[t], acc_lo[t], cur[t] = st
            g0 = g0 + DOT_STAGE
        total = np.where(cur >= 0, total + (acc_hi + acc_lo), total)
        idx = r0s[:, None] + np.arange(DOT_ROWS)
        out[s, idx] = total
        written[s, idx] += 1
    assert (written == 1).all()  # every row by exactly one lane of one tile
    return out.reshape(n_sub, row_hi, 128)


def _dot_inputs(seed, n_sub, n, row_hi, case):
    """Row ids, q and the live mask made with numpy.

    ``mixed``: ids uniform over the row space, with dead entries (q = 0,
    ids ≥ R where the int16 range has them, negative ids) and two runs of
    entries across the first two ``DOT_CHUNK`` boundaries on one row;
    ``one_row``: every entry on row 37 mod R."""
    rng = np.random.default_rng(seed)
    rows = row_hi * 128
    rowid = rng.integers(0, rows, (n_sub, n)).astype(np.int16)
    q = rng.normal(size=(n_sub, n)).astype(np.float32)
    if case == "one_row":
        rowid[:] = 37 % rows
    else:
        dead = rng.random((n_sub, n))
        q[dead < 0.1] = 0.0
        rowid[(dead >= 0.1) & (dead < 0.15)] = -1
        rowid[(dead >= 0.15) & (dead < 0.18)] = -32768
        if rows < 32768:
            rowid[(dead >= 0.18) & (dead < 0.22)] = rng.integers(rows, 32768)
        for c in (T.DOT_CHUNK, 2 * T.DOT_CHUNK):  # entries on a chunk boundary, one row
            rowid[:, max(c - 3, 0):c + 3] = 5 % rows
    live = (rowid >= 0) & (rowid < rows) & (q != 0)
    return rowid, q, live


def _dot_tolerance(q, rowid, row_hi):
    n_sub, rows = q.shape[0], row_hi * 128
    absum = np.zeros((n_sub, rows))
    for s in range(n_sub):
        ok = (rowid[s] >= 0) & (rowid[s] < rows)
        np.add.at(absum[s], rowid[s][ok].astype(np.int64), np.abs(q[s][ok]))
    return 1e-5 * absum.reshape(n_sub, row_hi, 128) + 1e-6


# one compile a shape, not one an operation
_DOT_XLA = jax.jit(J.dot_crossing_xla, static_argnums=3)
_MULT_XLA = jax.jit(J.mult_crossing_xla, static_argnums=3)


def _jax_rows(rowid):
    r = rowid.astype(np.int32)
    return jnp.asarray(r // 128), jnp.asarray(r % 128)


def _order(rowid, row_hi, live=None):
    return (t.numpy() for t in T.row_order(
        torch.from_numpy(rowid), row_hi, None if live is None else torch.from_numpy(live)))


@pytest.mark.parametrize("row_hi", (1, 4, 128, 256))
@pytest.mark.parametrize("n_sub", (1, 4))
@pytest.mark.parametrize("n", (1, 7, 8, 8199))
def test_dot_tiles_equal_todays_walk_and_the_premat_order(n, n_sub, row_hi):
    rowid, q, live = _dot_inputs(n * 7 + n_sub + row_hi, n_sub, n, row_hi, "mixed")
    want = emulate_dot_build(q, rowid, row_hi)
    assert not np.isnan(want).any()
    for lv in (None, live):  # every id in range, or the live entries only (the layout's order)
        row_ptr, entry_of = _order(rowid, row_hi, lv)
        for eo_word in (0, 1, 3):
            got = emulate_dot_tiles(q, row_ptr, entry_of, row_hi, eo_word)
            np.testing.assert_array_equal(got, want)
    assert not np.signbit(want[want == 0]).any()  # a row without a live entry is +0
    if n_sub == 4 and row_hi in (4, 256):  # the premat kernel's order, with its h-groups
        oh_hi, oh_lo = T.premat_row_onehots(torch.from_numpy(rowid), row_hi)
        np.testing.assert_array_equal(emulate_dot_premat(q, oh_hi, oh_lo), want)
    tol = _dot_tolerance(q, rowid, row_hi)
    rhi, rlo = _jax_rows(rowid)
    assert np.all(np.abs(want - np.asarray(_DOT_XLA(jnp.asarray(q), rhi, rlo, row_hi))) <= tol)
    if n_sub == 4 and row_hi in (1, 4):  # interpret mode compiles for each shape: a few shapes
        ref = np.asarray(J.dot_crossing_pallas(jnp.asarray(q), rhi, rlo, row_hi, interpret=True))
        assert np.all(np.abs(want - ref) <= tol)


@pytest.mark.parametrize("n_sub,row_hi,n", ((1, 1, 8199), (4, 4, DOT_STAGE + 1100), (4, 128, DOT_STAGE + 5)))
def test_dot_one_row_holding_every_entry_walks_its_pieces(n_sub, row_hi, n):
    rowid, q, _ = _dot_inputs(n_sub + row_hi, n_sub, n, row_hi, "one_row")
    row_ptr, entry_of = _order(rowid, row_hi)
    want = emulate_dot_build(q, rowid, row_hi)
    np.testing.assert_array_equal(emulate_dot_tiles(q, row_ptr, entry_of, row_hi, eo_word=2), want)
    # the row's tile takes ceil((n + mis) / DOT_STAGE) pieces; its chunks cross them
    assert len(piece_starts(0, n, 2)) == -(-(n + 2) // DOT_STAGE) > 1
    rhi, rlo = _jax_rows(rowid)
    ref = (J.dot_crossing_pallas(jnp.asarray(q), rhi, rlo, row_hi, interpret=True) if n_sub == 1
           else _DOT_XLA(jnp.asarray(q), rhi, rlo, row_hi))
    assert np.all(np.abs(want - np.asarray(ref)) <= _dot_tolerance(q, rowid, row_hi))
    nz = np.flatnonzero(want.reshape(n_sub, -1)[0])
    np.testing.assert_array_equal(nz, [37 % (row_hi * 128)])


@pytest.mark.parametrize("extra", (-1, 0, 1, DOT_STAGE + 3))
@pytest.mark.parametrize("lead", (0, 1, 2, 3))
def test_dot_ranges_at_the_stage_edge(extra, lead):
    """A tile whose range ends just before, at and past a piece, starting
    ``lead`` entries into entry_of, at every misalignment of its base."""
    row_hi, n_sub = 1, 2
    rows = row_hi * 128
    size = DOT_STAGE + extra
    n = lead + size + 64
    rng = np.random.default_rng(lead * 7 + extra + 2)
    rowid = np.empty((n_sub, n), np.int16)
    rowid[:, :lead] = rng.integers(0, 32, lead)  # tile 0 (rows 0-31)
    rowid[:, lead:lead + size] = rng.integers(32, 64, size)  # tile 1
    rowid[:, lead + size:] = rng.integers(64, rows, n - lead - size)
    q = rng.normal(size=(n_sub, n)).astype(np.float32)
    row_ptr, entry_of = _order(rowid, row_hi)
    assert (row_ptr[0, 32], row_ptr[0, 64]) == (lead, lead + size)
    want = emulate_dot_build(q, rowid, row_hi)
    for eo_word in range(4):
        np.testing.assert_array_equal(emulate_dot_tiles(q, row_ptr, entry_of, row_hi, eo_word), want)


@pytest.mark.parametrize("mis", (0, 1, 2, 3))
def test_stage_plan_copies_each_entry_once_on_aligned_words(mis):
    for b, e in ((0, 0), (0, 1), (1, 2), (3, 5), (0, 4), (2, 130), (5, 1541), (0, 3000), (7, 4000)):
        starts = piece_starts(b, e, mis)
        assert all((g0 + mis) % 4 == 0 for g0 in starts)
        seen = np.zeros(max(e, 1), np.int64)
        for g0 in starts:
            lo, hi = max(b - g0, 0), min(e - g0, DOT_STAGE)
            assert 0 <= lo <= 3 and hi <= DOT_STAGE
            for _, p, nbytes in stage_plan(lo, hi):
                width = nbytes // 4
                assert lo <= p and p + width <= hi
                if nbytes == 16:  # a whole word: aligned in the stage and in entry_of
                    assert p % 4 == 0 and (g0 + p + mis) % 4 == 0
                seen[g0 + p:g0 + p + width] += 1
        np.testing.assert_array_equal(seen[b:e], 1)
        assert not seen[:b].any()


# ---------------------------------------------------------------------------
# the mult
# ---------------------------------------------------------------------------


def _crossed(m):
    hi = _bf16(m)
    return hi + _bf16(m - hi)


def emulate_mult(mult3, rowid, rid_slot=0, out_slot=0, blocks=1):
    """The build-form mult kernel ([n_sub, n]). ``rid_slot`` / ``out_slot``:
    the first id's and the first output's offsets in 2- and 4-byte slots past
    a 16-byte boundary; ``blocks`` the grid's blocks a sub-batch."""
    m = np.asarray(mult3, np.float32)
    n_sub, row_hi, _ = m.shape
    rows = row_hi * 128
    n = rowid.shape[1]
    out = np.full((n_sub, n), np.nan, np.float32)
    written = np.zeros((n_sub, n), np.int64)
    stride = blocks * MULT_THREADS
    for s in range(n_sub):
        ms = m[s].reshape(-1)

        def at(r):
            r = r.astype(np.int64)
            ok = (r >= 0) & (r < rows)
            return np.where(ok, _crossed(ms[np.where(ok, r, 0)]), np.float32(0))

        mis = (rid_slot + s * n) & 7
        head = min(n, (8 - mis) & 7)
        groups = (n - head) // 8
        tail = head + 8 * groups
        if groups:
            assert (rid_slot + s * n + head) % 8 == 0  # 16-byte words of ids
        # the stores: two 16-byte words a group where the outputs sit on a
        # word boundary too, else eight 4-byte ones (the same values)
        vec_out = (out_slot + s * n + head) % 4 == 0
        assert groups == 0 or vec_out == ((out_slot - rid_slot) % 4 == 0)
        for i in list(range(head)) + list(range(tail, n)):  # threads 0-15 of block 0
            out[s, i] = at(rowid[s, i:i + 1])[0]
            written[s, i] += 1
        # thread t of the grid: groups t, t + stride, ..., MULT_IN_FLIGHT a round
        starts = np.arange(stride)
        for r in range(-(-groups // (stride * MULT_IN_FLIGHT)) if groups else 0):
            for k in range(MULT_IN_FLIGHT):
                g = starts + (r * MULT_IN_FLIGHT + k) * stride
                g = g[g < groups]
                slots = head + 8 * g[:, None] + np.arange(8)
                out[s, slots] = at(rowid[s, slots])
                written[s, slots] += 1
    assert (written == 1).all()
    return out


def _mult_inputs(seed, n_sub, n, row_hi):
    rng = np.random.default_rng(seed)
    rows = row_hi * 128
    rowid = rng.integers(0, rows, (n_sub, n)).astype(np.int16)
    pick = rng.random((n_sub, n))
    rowid[pick < 0.05] = -1
    rowid[(pick >= 0.05) & (pick < 0.08)] = -32768
    if rows < 32768:
        rowid[(pick >= 0.08) & (pick < 0.12)] = rng.integers(rows, 32768)
    m3 = rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)
    return rowid, m3


@pytest.mark.parametrize("row_hi", (1, 4, 128, 256))
@pytest.mark.parametrize("n_sub", (1, 4))
@pytest.mark.parametrize("n", (1, 7, 8, 8199))
def test_mult_groups_equal_the_plain_and_jax_forms(n, n_sub, row_hi):
    rowid, m3 = _mult_inputs(n * 3 + n_sub + row_hi, n_sub, n, row_hi)
    want = T.mult_crossing_plain(torch.from_numpy(m3), torch.from_numpy(rowid)).numpy()
    for rid_slot, out_slot, blocks in ((0, 0, 1), (3, 0, 2), (1, 2, 1), (7, 0, 3)):
        np.testing.assert_array_equal(emulate_mult(m3, rowid, rid_slot, out_slot, blocks), want)
    rhi, rlo = _jax_rows(rowid)
    np.testing.assert_array_equal(want, np.asarray(_MULT_XLA(jnp.asarray(m3), rhi, rlo, row_hi)))


def test_mult_reads_every_row_an_int16_id_reaches():
    assert T.MULT_GROUP * 2 == 16 and MULT_THREADS % WARP == 0  # a group is one 16-byte word of ids
    # a row space past 32,768 rows (row_hi 260): ids at int16's ends, 9 slots
    # so that a group and a tail slot both hold them
    rowid = np.array([[32767, -1, 0, 5, 32767, 128, -32768, 1, 32767]], np.int16)
    m3 = np.random.default_rng(4).normal(size=(1, 260, 128)).astype(np.float32)
    want = T.mult_crossing_plain(torch.from_numpy(m3), torch.from_numpy(rowid)).numpy()
    assert want[0, 0] != 0 and want[0, 1] == 0 and want[0, 6] == 0
    for rid_slot in (0, 5):
        np.testing.assert_array_equal(emulate_mult(m3, rowid, rid_slot), want)


def test_the_python_constants_are_the_kernels():
    assert (T.DOT_ROWS, T.DOT_WARPS, T.DOT_STAGE, T.DOT_BATCH) == (DOT_ROWS, DOT_WARPS, DOT_STAGE, DOT_BATCH)
    assert DOT_ROWS == WARP and DOT_STAGE % 4 == 0
    assert T.DOT_CHUNK & (T.DOT_CHUNK - 1) == 0  # the kernel shifts by log2(DOT_CHUNK)
