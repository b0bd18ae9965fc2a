"""The algorithm of the fold's backward kernels (``csrc/flash_fold_bwd.cu``)
on the CPU: a plain PyTorch emulation of the one-pass dq kernel and of the
dkv kernel that takes its hand-off, held against the port's
``reference_fold_bwd`` and the JAX package's ``reference_fold_bwd`` on the
same numpy inputs. The kernels themselves run only on the card
(``test_torch_gpu.py``); this file checks what they compute.

The dq emulation walks the keys in tiles of the kernel's width (16) and
keeps, per row, what the kernel keeps: the running block max b, the count
of keys equal to it and their sum (both reset when b grows), and the
running reference R = max(m, b) seeded with the carried m, against which
Σ dP·P (in float64) and Σ dP·P·k are summed and rescaled by exp(R_old -
R_new) when R grows. A row with more max keys than the kernel's 32 slots
is summed again from ds formed key by key, as the kernel's second walk
does. With ``tf32`` every product's operands are split into TF32 hi and lo
as the kernels split them: hi is x with its low 13 mantissa bits cleared
(a truncation, not a rounding), lo = x - hi, of which the tensor cores read
the top bits (lo truncated the same way), and the product is lo·hi + hi·lo
+ hi·hi. The dkv emulation forms P and ds from the dq emulation's safe, B
and dB / cnt, with its scores from the same function.

Cases: the fold's flag cases of ``test_torch_attention_train.py`` plus a
block max that first appears in a late tile and grows tile after tile, equal
maxima in two different tiles, m equal to the block max on every third row
(above it on the next, -inf on the third), rows with nothing attendable
(with a finite and a -inf m), and every key equal (a row's scores all
tied: dq on a first fold is a difference of two sums ~150 times larger,
the 150 keys n_valid leaves; under causal the first 32 rows stay within
the slots). At all 256 keys the plain float32 VJP itself misses float64 by
more than the tolerance there, so the case keeps 150, as the card's does. Tolerance: each gradient within
2e-5 of |plain| + the tensor's largest magnitude (the kernels' bound on the
card: the rescales and the split round differently from the plain
version); rows with nothing attendable and keys no query attends exact.
Where an exact tie or m == B matters, q and k lie on a 1/8 grid (scale
1/8), so every score is exact in any order and in TF32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.parallel import flash as jflash

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.parallel import reference_fold_bwd

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

TILE = 16  # the dq kernel's streamed key tile (kStream in csrc/flash_fold_bwd.cu)
MAX_KEYS = 32  # the dq kernel's max-key slots a row (kMaxKeys): past them, its second walk
TOL = 2e-5
GRADS = ("dq", "dk", "dv", "dm", "dl", "dacc")
B, H, T = 1, 2, 256


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, tf32):
    """a @ b in float32, or in 3×TF32: lo·hi + hi·lo + hi·hi."""
    if not tf32:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale, tf32):
    """The kernels' score: q · kbᵀ, then one multiply by the scale, -inf
    where masked. Both emulated kernels take it from here, as both kernels
    take it from one device function."""
    s = _mm(q, kb.transpose(-1, -2), tf32) * scale
    Tq, Tk = q.shape[2], kb.shape[2]
    q_pos = q_pos0 + torch.arange(Tq)[:, None]
    k_pos = k_pos0 + torch.arange(Tk)[None, :]
    keep = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        keep &= q_pos >= k_pos
    if n_valid is not None:
        keep &= k_pos < n_valid
    return torch.where(keep, s, -torch.inf)


def onepass_dq(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale, dm, dl, dacc, tf32=False):
    """The dq kernel's one pass: ``(dq, dm_in, dl_in, dacc_in, safe, bmax,
    dbc)``, its outputs."""
    s_all = _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale, tf32)
    neg = torch.full_like(m, -torch.inf)
    run, bmax = m.clone(), neg
    cnt, sumw = torch.zeros_like(m), torch.zeros_like(m, dtype=torch.float64)
    acc1, acc2 = torch.zeros_like(q), torch.zeros_like(q)
    for k0 in range(0, kb.shape[2], TILE):
        s = s_all[..., k0:k0 + TILE]
        kt, vt = kb[..., k0:k0 + TILE, :], vb[..., k0:k0 + TILE, :]
        finite = ~torch.isneginf(s)
        tmax = s.amax(-1)
        c = ((s == tmax[..., None]) & finite).sum(-1).to(m.dtype)
        reset = tmax > bmax  # a new block max: its count and key sum start again
        hit = reset | ((tmax == bmax) & ~torch.isneginf(tmax))
        cnt = torch.where(reset, c, torch.where(hit, cnt + c, cnt))
        bmax = torch.where(reset, tmax, bmax)
        grown = torch.maximum(m, bmax)
        up = grown > run  # R grows: rescale what was summed against the old R
        f = torch.where(up, torch.where(torch.isneginf(run), 0.0, torch.exp(run - grown)), 1.0)
        sumw, acc1 = sumw * f.double(), acc1 * f[..., None]
        run = torch.where(up, grown, run)
        safe_now = torch.where(torch.isneginf(run), 0.0, run)
        p = torch.where(finite, torch.exp(s - safe_now[..., None]), 0.0)
        w = (dl[..., None] + _mm(dacc, vt.transpose(-1, -2), tf32)) * p
        sumw = sumw + w.double().sum(-1)
        acc1 = acc1 + _mm(w, kt, tf32)
        x = ((s == bmax[..., None]) & finite).to(q.dtype)  # exact in TF32: no lo part
        acc2 = torch.where(reset[..., None], 0.0, acc2) + _mm(x, kt, tf32)
    safe = torch.where(torch.isneginf(run), 0.0, run)
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
    dcorr = dl * l + torch.sum(dacc * acc, dim=-1)
    take = torch.where(m > bmax, 1.0, torch.where(m == bmax, 0.5, 0.0))
    dsafe = (-sumw - (dcorr * corr).double()).float()
    dnew = dm + torch.where(torch.isneginf(run), 0.0, dsafe)
    dbc = dnew * (1.0 - take) / torch.clamp(cnt, min=1.0)
    dq = acc1 + dbc[..., None] * acc2
    redo = cnt > MAX_KEYS
    if redo.any():  # the second walk: ds key by key, as the dkv kernel forms it
        finite = ~torch.isneginf(s_all)
        p = torch.where(finite, torch.exp(s_all - safe[..., None]), 0.0)
        is_max = (s_all == bmax[..., None]) & finite
        ds = (dl[..., None] + _mm(dacc, vb.transpose(-1, -2), tf32)) * p + torch.where(is_max, dbc[..., None], 0.0)
        again = torch.zeros_like(q)
        for k0 in range(0, kb.shape[2], TILE):
            again = again + _mm(ds[..., k0:k0 + TILE], kb[..., k0:k0 + TILE, :], tf32)
        dq = torch.where(redo[..., None], again, dq)
    dq = dq * scale
    dm_in = torch.where(torch.isneginf(m), 0.0, dcorr * corr) + dnew * take
    return dq, dm_in, dl * corr, dacc * corr[..., None], safe, bmax, dbc


def handoff_dkv(q, kb, vb, q_pos0, k_pos0, causal, n_valid, scale, dl, dacc, safe, bmax, dbc, tf32=False):
    """The dkv kernel from the dq kernel's hand-off: ``(dk, dv)``."""
    s = _scores(q, kb, q_pos0, k_pos0, causal, n_valid, scale, tf32)
    finite = ~torch.isneginf(s)
    p = torch.where(finite, torch.exp(s - safe[..., None]), 0.0)
    is_max = (s == bmax[..., None]) & finite
    ds = (dl[..., None] + _mm(dacc, vb.transpose(-1, -2), tf32)) * p + torch.where(is_max, dbc[..., None], 0.0)
    return _mm(ds.transpose(-1, -2), q, tf32) * scale, _mm(p.transpose(-1, -2), dacc, tf32)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

# name: (causal, n_valid, q_pos0, k_pos0, kind)
CASES = {
    "first-fold": (True, None, 0, 0, "first"),
    "mid-fold": (True, None, 512, 256, "carried"),
    "masked": (False, 300, 0, 256, "carried"),  # keys 256-299 valid, the rest masked
    "fully-masked": (False, 10, 0, 128, "first"),  # no row has an attendable key
    "plain": (False, None, 0, 0, "carried"),
    "ties": (False, 201, 0, 0, "ties"),  # every key doubled; m == B, above, below
    "late-max": (False, None, 0, 0, "late"),  # the block max grows tile after tile
    "ties-across-tiles": (False, None, 0, 0, "tiles"),  # equal maxima eight tiles apart
    "m-equals-block-max": (False, None, 0, 0, "m_eq_b"),
    "idle-rows": (True, None, 0, 2, "idle"),  # rows 0 and 1 attend nothing
    "every-key-equal": (False, 150, 0, 0, "equal"),  # the 150 attended keys tie: the second walk
    "every-key-equal-causal": (True, 150, 0, 0, "equal"),  # row r: r + 1 ties, slots then the walk
    "every-key-equal-carried": (False, 150, 0, 0, "equal_carried"),
}


def _case(name, d, seed=11):
    """Numpy inputs and cotangents of a case: ``(arrays, q_pos0, k_pos0,
    causal, n_valid, scale)``."""
    causal, nv, qp, kp, kind = CASES[name]
    rng = np.random.default_rng(seed + d)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def grid(*shape):
        return (rng.integers(-8, 9, size=shape) / 8).astype(np.float32)

    scale = np.float32(1.0 / np.sqrt(d))
    q, kb, vb = r(B, H, T, d), r(B, H, T, d), r(B, H, T, d)
    m, l, acc = r(B, H, T) * 0.5, np.abs(r(B, H, T)) + 0.5, r(B, H, T, d)
    if kind in ("ties", "tiles", "m_eq_b"):
        scale = np.float32(0.125)
        q, kb = grid(B, H, T, d), grid(B, H, T, d)
    if kind in ("equal", "equal_carried"):
        q, kb = grid(B, H, T, d), np.repeat(grid(B, H, 1, d), T, axis=2)
    if kind == "ties":
        kb[:, :, 1::2] = kb[:, :, 0::2]
    if kind == "tiles":
        kb[:, :, T // 2:] = kb[:, :, :T // 2]  # key j and key j + 128 are equal, eight tiles apart
    if kind == "late":
        kb *= (0.25 + 2.0 * np.arange(T) / T).astype(np.float32)[:, None]
    if kind in ("first", "late", "tiles", "equal"):
        m = np.full((B, H, T), -np.inf, np.float32)
        l = np.zeros((B, H, T), np.float32)
        acc = np.zeros((B, H, T, d), np.float32)
    if kind in ("ties", "m_eq_b"):
        s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), kb.astype(np.float64)) * scale
        block_max = s[..., :nv].max(axis=-1).astype(np.float32)  # exact
        if kind == "ties":
            m = block_max + np.float32(0.25) * np.array([0, 1, -1], np.float32)[np.arange(T) % 3]
        else:
            m = np.where(np.arange(T) % 3 == 0, block_max,
                         np.where(np.arange(T) % 3 == 1, block_max + np.float32(0.5), -np.inf)).astype(np.float32)
    if kind == "idle":
        m[..., 0] = -np.inf  # row 0: nothing attendable and a -inf m; row 1: a finite m
    dm, dl, dacc = r(B, H, T), r(B, H, T), r(B, H, T, d)
    return (q, kb, vb, m, l, acc, dm, dl, dacc), qp, kp, causal, nv, float(scale)


def _emulate(arrays, qp, kp, causal, nv, scale, tf32):
    x = [_t(a) for a in arrays]
    dq, dm_in, dl_in, dacc_in, safe, bmax, dbc = onepass_dq(*x[:6], qp, kp, causal, nv, scale, *x[6:], tf32=tf32)
    dk, dv = handoff_dkv(*x[:3], qp, kp, causal, nv, scale, x[7], x[8], safe, bmax, dbc, tf32=tf32)
    return (dq, dk, dv, dm_in, dl_in, dacc_in), (safe, bmax, dbc)


def _assert_within(got, want, where):
    for name, g, w in zip(GRADS, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert not np.isnan(g).any(), f"{where} {name}"
        err = np.abs(g - w)
        bound = TOL * (np.abs(w) + max(1.0, float(np.abs(w).max())))
        assert np.all(err <= bound), f"{where} {name}: {err.max()}"


def _attends(Tq, Tk, qp, kp, causal, nv):
    q_pos, k_pos = qp + np.arange(Tq)[:, None], kp + np.arange(Tk)[None, :]
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= q_pos >= k_pos
    if nv is not None:
        keep &= k_pos < nv
    return keep


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tf32", (False, True), ids=("f32", "3xtf32"))
@pytest.mark.parametrize("d", (8, 64))
@pytest.mark.parametrize("case", tuple(CASES))
def test_onepass_emulation_matches_both_plain_vjps(case, d, tf32):
    arrays, qp, kp, causal, nv, scale = _case(case, d)
    got, (safe, bmax, dbc) = _emulate(arrays, qp, kp, causal, nv, scale, tf32)
    port = reference_fold_bwd(*(_t(a) for a in arrays[:6]), qp, kp, causal, nv, scale,
                              *(_t(a) for a in arrays[6:]))
    jax_ref = jflash.reference_fold_bwd(*(jnp.asarray(a) for a in arrays[:6]), qp, kp, causal, nv, scale,
                                        *(jnp.asarray(a) for a in arrays[6:]))
    where = f"{case} d={d} tf32={tf32}"
    _assert_within([g.numpy() for g in got], [w.numpy() for w in port], f"{where} vs the port")
    _assert_within([g.numpy() for g in got], jax_ref, f"{where} vs JAX")
    # exact edges: rows with nothing attendable, keys that nothing attends
    m = arrays[3]
    keep = _attends(T, T, qp, kp, causal, nv)
    idle, unattended = ~keep.any(axis=1), ~keep.any(axis=0)
    dq, dk, dv, dm_in, dl_in, dacc_in = (g.numpy() for g in got)
    assert np.all(dq[..., idle, :] == 0)
    np.testing.assert_array_equal(dl_in[..., idle], port[4].numpy()[..., idle])
    np.testing.assert_array_equal(dacc_in[..., idle, :], port[5].numpy()[..., idle, :])
    fresh = idle[None, None, :] & np.isneginf(m)
    np.testing.assert_array_equal(dm_in[fresh], arrays[6][fresh] * np.float32(0.5))
    assert np.all(dk[..., unattended, :] == 0) and np.all(dv[..., unattended, :] == 0)
    # the hand-off: safe and the block max as the plain version's
    s = _scores(*(_t(a) for a in arrays[:2]), qp, kp, causal, nv, scale, tf32)
    plain_max = s.amax(-1)
    np.testing.assert_array_equal(bmax.numpy(), plain_max.numpy())
    new_m = np.maximum(m, plain_max.numpy())
    np.testing.assert_array_equal(safe.numpy(), np.where(np.isneginf(new_m), 0.0, new_m))
    assert not np.isnan(dbc.numpy()).any()


@pytest.mark.parametrize("case", ("late-max", "ties-across-tiles", "m-equals-block-max", "idle-rows", "ties",
                                  "every-key-equal", "every-key-equal-causal"))
def test_each_added_case_reaches_its_edge(case):
    """What each added case is for is in its inputs: the block max first
    seen late and grown across tiles (so R is rescaled), equal maxima in two
    tiles, m equal to the block max, rows with nothing attendable, every
    attended key tied (past the 32 slots, and under causal also within)."""
    arrays, qp, kp, causal, nv, scale = _case(case, 64)
    s = _scores(*(_t(a) for a in arrays[:2]), qp, kp, causal, nv, scale, False).numpy()
    m = arrays[3]
    finite = np.isfinite(s.max(axis=-1))
    argmax_tile = s.argmax(axis=-1) // TILE
    if case == "late-max":
        assert np.mean(argmax_tile[finite] >= T // TILE - 4) > 0.5  # most rows peak in the last 4 tiles
        tile_max = s.reshape(B, H, T, T // TILE, TILE).max(axis=-1)
        grows = (np.diff(np.maximum.accumulate(tile_max, axis=-1), axis=-1) > 0).sum(axis=-1)
        assert np.mean(grows) > 2  # the running max grows (and R is rescaled) several times a row
    if case in ("ties-across-tiles", "ties"):
        is_max = s == s.max(axis=-1, keepdims=True)
        tiles_with_max = is_max.reshape(B, H, T, T // TILE, TILE).any(axis=-1).sum(axis=-1)
        if case == "ties-across-tiles":
            assert np.all(tiles_with_max >= 2)  # each max key's twin lies eight tiles on
        else:
            assert np.mean(is_max.sum(axis=-1) >= 2) > 0.9
    if case in ("m-equals-block-max", "ties"):
        assert np.all((m == s.max(axis=-1))[..., ::3])
    if case.startswith("every-key-equal"):
        ties = (s == s.max(axis=-1, keepdims=True)).sum(axis=-1)
        assert np.all(ties == np.isfinite(s).sum(axis=-1))  # every attendable key ties
        assert np.any(ties > MAX_KEYS) and (case == "every-key-equal" or np.any(ties <= MAX_KEYS))
    if case == "idle-rows":
        assert not np.isfinite(s[..., :2, :]).any() and np.isfinite(s[..., 2:, :].max(axis=-1)).all()
        assert np.isneginf(m[..., 0]).all() and np.isfinite(m[..., 1]).all()
