"""The arithmetic of the forward fold kernel (``csrc/flash_fold.cu``) on the
CPU: a plain PyTorch emulation of what the kernel computes, held against the
port's ``reference_fold``, the JAX package's ``reference_fold`` and the JAX
``_fold_pallas`` in interpret mode, on the same numpy inputs. The kernel
itself runs only on the card (``test_torch_gpu.py``); this file checks its
algorithm.

The emulation follows the kernel: keys in tiles of its width (32; 8 past a
head dim of 128), tiles the mask covers wholly skipped; per tile, S = Q·Kᵀ
in 3×TF32 — every operand split as the kernel splits it, hi being x with
its low 13 mantissa bits cleared (a truncation, not a rounding) and lo = x -
hi, of which the tensor cores read the top bits (lo truncated the same
way), a product being lo·hi + hi·lo + hi·hi — summed in stretches of 64
columns that are then added in float32; scale and mask; the online
rescale in the kernel's order (new max, safe max, a correction of exactly 1
where the max did not move, p = exp(s - safe), l = l·correction + Σp, O =
O·correction + P·V in one fused multiply-add); P·V in 3×TF32 with the keys
of each 8-key slice in the kernel's order (0, 2, 4, 6, 1, 3, 5, 7, the same
for P's columns and Vᵀ's, so the sum over keys does not change).

Cases: the fold's flag cases of ``test_torch_attention.py`` (causal, n_valid
inside or before the block, the block before, after or straddling the
queries; first, carried and mixed states) at head dims 8, 100 and 128, rows
with nothing attendable among them, and every key equal (one repeated
token: the classifier has no position embedding), also at head dim 256.

Tolerance, the kernel's own gates on the card (``chip_smoke.py``
kernels_flash): m within 1e-6 of |m| plus the scores' term magnitude (a
score is a dot product, and one that cancels to near 0 keeps the error of
its terms), l and acc within 1e-5 relative with an atol of 1e-5 times the
tensor's largest magnitude — the split, the stretches and the tile-wise
rescale sum in another order than the plain fold; rows with nothing
attendable exact. A bfloat16 control (q, k and v rounded to bfloat16, the
emulation otherwise the same) must land outside that tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.parallel import flash as jflash

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.parallel import TILE_K, reference_fold

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

STRETCH = 64  # columns of D summed inside the MMA before a float32 add (kStretch k-steps of 8)
M_RTOL, RTOL = 1e-6, 1e-5
B, H = 1, 2
# the key order within an 8-key slice of Vᵀ: k position p holds key ORDER[p]
ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
POSITIONS = {
    "aligned": lambda Tq, Tk: (0, 0),
    "kv_before": lambda Tq, Tk: (Tk + 8, 0),  # the queries lie after the whole block
    "kv_after": lambda Tq, Tk: (0, Tq + 8),  # the block lies after every query
    "straddle": lambda Tq, Tk: (16, 0),
}
N_VALID = ("none", "inside", "before_block")
STATES = ("first", "carried", "mixed")


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


def _mm3(a, b):
    """a @ b in 3×TF32: lo·hi + hi·lo + hi·hi, float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def key_tile(d):
    """The kernel's key tile at head dim ``d`` (its kBN)."""
    return TILE_K if d <= 128 else 8


def _slice_order(n):
    """The kernel's key order within each 8-key slice of a tile of ``n`` keys
    (a multiple of 8)."""
    return torch.tensor([8 * (p // 8) + ORDER[p % 8] for p in range(n)])


def emulate_fold(q, kb, vb, m, l, acc, q_pos0, k_pos0, causal, n_valid, scale):
    """The kernel's fold, op for op in its order: ``(m, l, acc)``."""
    Tq, Tk, d = q.shape[2], kb.shape[2], q.shape[3]
    tile = key_tile(d)
    neg = torch.isneginf(m)
    m_run = m.clone()
    l_run = torch.where(neg, l * 0.0, l)  # the reference's correction 0, applied once
    o = torch.where(neg[..., None], acc * 0.0, acc)
    q_pos = q_pos0 + torch.arange(Tq)
    mask_end = Tk if n_valid is None else min(Tk, n_valid - k_pos0)
    key_end = mask_end if not causal else min(mask_end, q_pos0 + Tq - 1 - k_pos0 + 1)
    for k0 in range(0, max(0, key_end), tile):
        n = min(tile, Tk - k0)
        kt = torch.zeros(q.shape[:2] + (tile, d))  # a ragged last tile is zero-filled, as staged
        vt = torch.zeros(q.shape[:2] + (tile, d))
        kt[..., :n, :], vt[..., :n, :] = kb[..., k0:k0 + n, :], vb[..., k0:k0 + n, :]
        s = None
        for c0 in range(0, d, STRETCH):  # stretches, added in float32
            part = _mm3(q[..., c0:c0 + STRETCH], kt[..., c0:c0 + STRETCH].transpose(-1, -2))
            s = part if s is None else s + part
        key = k0 + torch.arange(tile)
        keep = (key < mask_end)[None, :].expand(Tq, tile)
        if causal:
            keep = keep & (q_pos[:, None] >= (k_pos0 + key)[None, :])
        s = torch.where(keep, s * scale, -torch.inf)
        new_m = torch.maximum(m_run, s.amax(-1))
        safe = torch.where(torch.isneginf(new_m), 0.0, new_m)
        corr = torch.where(torch.isneginf(m_run), 0.0,
                           torch.where(m_run == safe, 1.0, torch.exp(m_run - safe)))
        p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - safe[..., None]))
        l_run = l_run * corr + p.sum(-1)
        order = _slice_order(tile)
        pv = _mm3(p[..., order], vt[..., order, :])
        o = (o.double() * corr[..., None].double() + pv.double()).float()  # one fused multiply-add
        m_run = new_m
    return m_run, l_run, o


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _inputs(seed, Tq, Tk, d, state, every_key_equal=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    if every_key_equal:
        k = np.repeat(k[:, :, :1], Tk, axis=2)
    if state == "first":
        m = np.full((B, H, Tq), -np.inf, np.float32)
        l = np.zeros((B, H, Tq), np.float32)
        acc = np.zeros((B, H, Tq, d), np.float32)
    else:
        m = rng.standard_normal((B, H, Tq)).astype(np.float32)
        l = (np.abs(rng.standard_normal((B, H, Tq))) + 1.0).astype(np.float32)
        acc = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
        if state == "mixed":  # every third row has seen nothing yet
            m[..., ::3], l[..., ::3], acc[..., ::3, :] = -np.inf, 0.0, 0.0
    return q, k, v, m, l, acc


def _n_valid(case, k_pos0, Tk):
    return {"none": None, "inside": k_pos0 + Tk // 2, "before_block": k_pos0}[case]


def _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid):
    q_pos, k_pos = q_pos0 + np.arange(Tq)[:, None], k_pos0 + np.arange(Tk)[None, :]
    keep = np.ones((Tq, Tk), bool)
    if causal:
        keep &= q_pos >= k_pos
    if n_valid is not None:
        keep &= k_pos < n_valid
    return ~keep.any(axis=1)


def _s_mag(q, k, scale):
    return scale * np.einsum("bhqd,bhkd->bhqk", np.abs(q), np.abs(k)).max(axis=-1)


def _within(got, want, s_mag):
    """Whether ``got`` is within the kernel's gates of ``want``; the largest
    error in units of each bound."""
    gm, gl, ga = (np.asarray(x, np.float64) for x in got)
    wm, wl, wa = (np.asarray(x, np.float64) for x in want)
    if not np.array_equal(np.isneginf(gm), np.isneginf(wm)) or any(np.isnan(x).any() for x in (gm, gl, ga)):
        return False, np.inf
    fin = np.isfinite(wm)
    ratios = [np.max(np.abs(gm[fin] - wm[fin]) / (M_RTOL * (np.abs(wm[fin]) + s_mag[fin])), initial=0.0)]
    for g, w in ((gl, wl), (ga, wa)):
        ratios.append(np.max(np.abs(g - w) / (RTOL * np.abs(w) + RTOL * max(1.0, np.abs(w).max())), initial=0.0))
    worst = float(max(ratios))
    return worst <= 1.0, worst


def _assert_exact_edges(got, inputs, idle):
    """Rows with nothing attendable: a finite state kept bit for bit, a -inf
    m gives (-inf, 0, 0)."""
    m_in, l_in, acc_in = inputs
    gm, gl, ga = (np.asarray(x) for x in got)
    seen = np.isfinite(m_in)
    kept, fresh = seen & idle[None, None, :], ~seen & idle[None, None, :]
    np.testing.assert_array_equal(gm[kept], m_in[kept])
    np.testing.assert_array_equal(gl[kept], l_in[kept])
    np.testing.assert_array_equal(ga[kept], acc_in[kept])
    assert np.all(np.isneginf(gm[fresh])) and np.all(gl[fresh] == 0) and np.all(ga[fresh] == 0)


def _run(inputs, q_pos0, k_pos0, causal, n_valid, scale):
    return emulate_fold(*(_t(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("positions", sorted(POSITIONS))
@pytest.mark.parametrize("n_valid_case", N_VALID)
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("d", (8, 100, 128))
def test_emulated_kernel_matches_both_plain_folds(d, causal, n_valid_case, positions, state):
    Tq, Tk = 40, 75  # three key tiles, the last ragged
    q_pos0, k_pos0 = POSITIONS[positions](Tq, Tk)
    n_valid = _n_valid(n_valid_case, k_pos0, Tk)
    inputs = _inputs(7 + d, Tq, Tk, d, state)
    scale = float(1.0 / np.sqrt(d))
    got = _run(inputs, q_pos0, k_pos0, causal, n_valid, scale)
    port = reference_fold(*(_t(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale)
    jax_ref = jflash.reference_fold(*inputs, q_pos0, k_pos0, causal, n_valid, scale)
    s_mag = _s_mag(inputs[0], inputs[1], scale)
    for name, want in (("the port", [x.numpy() for x in port]), ("JAX", [np.asarray(x) for x in jax_ref])):
        ok, worst = _within([x.numpy() for x in got], want, s_mag)
        assert ok, f"vs {name}: {worst} of the bound"
    idle = _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid)
    _assert_exact_edges([x.numpy() for x in got], inputs[3:], idle)


# (causal, n_valid case, positions, state): the Pallas fold needs Tq a
# multiple of its 256-row tile, and interpret mode costs about a second each
PALLAS_CASES = [
    (True, "none", "aligned", "first"),
    (True, "none", "kv_after", "first"),  # every row masked: m stays -inf
    (False, "inside", "aligned", "carried"),
    (True, "inside", "kv_before", "mixed"),
    (False, "before_block", "aligned", "mixed"),
    (True, "none", "straddle", "carried"),
]


@pytest.mark.parametrize("causal,n_valid_case,positions,state", PALLAS_CASES)
def test_emulated_kernel_matches_the_pallas_fold_in_interpret_mode(causal, n_valid_case, positions, state):
    Tq, Tk, d = 256, 200, 100
    q_pos0, k_pos0 = POSITIONS[positions](Tq, Tk)
    n_valid = _n_valid(n_valid_case, k_pos0, Tk)
    inputs = _inputs(11, Tq, Tk, d, state)
    scale = float(1.0 / np.sqrt(d))
    got = _run(inputs, q_pos0, k_pos0, causal, n_valid, scale)
    want = jflash._fold_pallas(*(jnp.asarray(a) for a in inputs), q_pos0, k_pos0, causal, n_valid, scale,
                               interpret=True)
    ok, worst = _within([x.numpy() for x in got], [np.asarray(x) for x in want], _s_mag(inputs[0], inputs[1], scale))
    assert ok, f"{worst} of the bound"
    _assert_exact_edges([x.numpy() for x in got], inputs[3:], _idle_rows(Tq, Tk, q_pos0, k_pos0, causal, n_valid))


@pytest.mark.parametrize("state", ("first", "carried", "mixed"))
@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("d", (8, 100, 128, 256))
def test_emulated_kernel_holds_when_every_key_is_equal(d, causal, state):
    """One token repeated over the whole block: every attendable score of a
    row ties, so p is 1 for each of them and acc is l times v's mean over
    those keys — the sum over keys that the tiles, the key order and the
    rescale all touch."""
    Tq, Tk = 40, 100
    inputs = _inputs(3 + d, Tq, Tk, d, state, every_key_equal=True)
    scale = float(1.0 / np.sqrt(d))
    n_valid = 90
    got = _run(inputs, 0, 0, causal, n_valid, scale)
    port = reference_fold(*(_t(a) for a in inputs), 0, 0, causal, n_valid, scale)
    jax_ref = jflash.reference_fold(*inputs, 0, 0, causal, n_valid, scale)
    s_mag = _s_mag(inputs[0], inputs[1], scale)
    for name, want in (("the port", [x.numpy() for x in port]), ("JAX", [np.asarray(x) for x in jax_ref])):
        ok, worst = _within([x.numpy() for x in got], want, s_mag)
        assert ok, f"vs {name}: {worst} of the bound"
    # the case is what it says: every attendable score of a row ties
    s = np.einsum("bhqd,bhkd->bhqk", inputs[0], inputs[1])[..., :n_valid]
    assert np.all(s == s[..., :1])


@pytest.mark.parametrize("d", (8, 128))
def test_a_bfloat16_control_lands_outside_the_tolerance(d):
    """The same emulation on q, k and v rounded to bfloat16 misses the plain
    float32 fold by more than the gates allow: they can tell the kernel's
    3×TF32 arithmetic from a 16-bit one."""
    Tq, Tk = 40, 75
    inputs = _inputs(5 + d, Tq, Tk, d, "carried")
    scale = float(1.0 / np.sqrt(d))
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in inputs[:3]] + list(inputs[3:])
    want = [x.numpy() for x in reference_fold(*(_t(a) for a in inputs), 0, 0, False, None, scale)]
    s_mag = _s_mag(inputs[0], inputs[1], scale)
    ok, worst = _within([x.numpy() for x in _run(inputs, 0, 0, False, None, scale)], want, s_mag)
    assert ok and worst < 0.5, worst
    ok, worst = _within([x.numpy() for x in _run(rounded, 0, 0, False, None, scale)], want, s_mag)
    assert not ok and worst > 10, worst


def test_the_key_order_of_vt_matches_the_register_fragment():
    """In a thread's S accumulator (wgmma's m64nN layout) element e of quad
    j holds row g + 8·(e // 2) and key 8j + 2t + e % 2; its A fragment of
    P·V (the m64k8 TF32 register layout) holds, in slot x, row g + 8·(x % 2)
    and k position t + 4·(x // 2). The kernel puts element e in slot
    a_pos(e) = (0, 2, 1, 3)[e], so k position p must hold key ORDER[p] —
    which is how the loader writes Vᵀ: item pq takes keys 8·(pq // 2) +
    pq % 2 + 2m to k positions 4·pq + m."""
    a_pos = (0, 2, 1, 3)
    for t in range(4):
        for e in range(4):
            key = 2 * t + e % 2
            x = a_pos[e]
            assert x % 2 == e // 2  # the same row
            position = t + 4 * (x // 2)
            assert ORDER[position] == key
    written = {}
    for pq in range(TILE_K // 4):
        for m in range(4):
            written[4 * pq + m] = 8 * (pq // 2) + pq % 2 + 2 * m
    assert [written[p] for p in range(TILE_K)] == _slice_order(TILE_K).tolist()
    assert sorted(written.values()) == list(range(TILE_K))
