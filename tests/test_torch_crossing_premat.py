"""The premat crossing kernels' arithmetic, emulated on the CPU.

``csrc/onehot_crossing.cu`` cannot run here, so this file holds a numpy
float32 emulation of what its two premat kernels compute and in which order,
and holds that against the build-form kernel's order, the port's plain
versions and the JAX package:

- the premat dot: per (sub-batch, chunk of ``DOT_CHUNK`` entries, group of
  128 ``h`` rows), the entries with q != 0 in ascending order; an entry with
  one nonzero in each one-hot row (simple) adds ``a·bf16(v·q_half)`` to its
  row's accumulator of each half, any other (general) adds every nonzero
  pair at its place; the halves are added at the chunk's end and the chunk
  partials in ascending order. Held bit-equal to an emulation of the
  build-form kernel's row-sorted walk (:func:`row_order`) and within
  ``1e-5·Σ_row|q| + 1e-6`` to the JAX ``dot_crossing_premat_pallas`` in
  interpret mode;
- the premat mult: a simple entry gives ``0 + (a·m_hi + a·m_lo)·v``; a
  general one, for each nonzero oh_lo column l ascending, ``ph = Σ_h a·m_hi``
  and ``pl = Σ_h a·m_lo`` over the nonzero h ascending, ``u += (ph + pl)·v``.
  Held bit-equal to ``mult_crossing_premat_plain`` and the JAX
  ``mult_crossing_premat_xla`` on one-hot stacks; on general rows within
  ``1e-6`` of ``Σ_l |v| Σ_h |a|·(|m_hi| + |m_lo|)`` (another summation order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.linalg.onehot_sparse as J
from flink_ml_tpu.config import Options as JOptions, config as jconfig
import flink_ml_tpu_torch.linalg.onehot_sparse as T
from flink_ml_tpu_torch.config import Options, config

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

H_GROUP = 128  # h rows per work unit of the premat dot kernel


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


# ---------------------------------------------------------------------------
# bf16 as the kernels read it
# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> np.ndarray:
    """bf16 tensor -> its raw 16-bit words."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _word(bits: np.ndarray) -> np.ndarray:
    """bf16 words -> float32 (a 16-bit shift)."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> nearest-even bf16, kept as float32."""
    b = np.asarray(x, np.float32).view(np.uint32)
    r = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def _nonzero(bits: np.ndarray) -> np.ndarray:
    return (bits & 0x7FFF) != 0  # -0 counts as zero


def _window(oh_hi, oh_lo, wi):
    if oh_hi.dim() == 4:
        oh_hi, oh_lo = oh_hi[wi], oh_lo[wi]
    return _bits(oh_hi), _bits(oh_lo)


# ---------------------------------------------------------------------------
# the emulations
# ---------------------------------------------------------------------------


def emulate_dot_premat(q, oh_hi, oh_lo, wi=0, chunk=T.DOT_CHUNK):
    """The premat dot kernel's arithmetic in its order ([n_sub, row_hi, 128])."""
    hi_b, lo_b = _window(oh_hi, oh_lo, wi)
    q = np.asarray(q, np.float32)
    n_sub, n = q.shape
    n_pad, row_hi = hi_b.shape[1], hi_b.shape[2]
    n_chunks = -(-n_pad // chunk)
    partial = np.zeros((n_sub, n_chunks, row_hi, 128), np.float32)
    for s in range(n_sub):
        for c in range(n_chunks):
            e = np.arange(c * chunk, min((c + 1) * chunk, n_pad, n))
            e = e[q[s, e] != 0]  # the loader gathers live entries only
            qh = _bf16(q[s, e])
            ql = _bf16(q[s, e] - qh)
            lo = lo_b[s, e]
            for h0 in range(0, row_hi, H_GROUP):
                hi = hi_b[s, e, h0:h0 + H_GROUP]
                hw = hi.shape[1]
                acc = np.zeros((2, hw * 128), np.float32)
                hi_nz, lo_nz = _nonzero(hi), _nonzero(lo)
                hc, lc = hi_nz.sum(1), lo_nz.sum(1)
                simple = (hc == 1) & (lc == 1)
                general = np.flatnonzero((hc > 0) & (lc > 0) & ~simple)
                h = hi_nz.argmax(1)
                l = lo_nz.argmax(1)
                a = _word(hi[np.arange(len(e)), h])
                v = _word(lo[np.arange(len(e)), l])
                key = h * 128 + l
                th = a * _bf16(v * qh)
                tl = a * _bf16(v * ql)
                start = 0
                for j in list(general) + [len(e)]:
                    seg = np.arange(start, j)
                    seg = seg[simple[seg]]
                    np.add.at(acc[0], key[seg], th[seg])  # sequential, in entry order
                    np.add.at(acc[1], key[seg], tl[seg])
                    if j < len(e):  # a general entry: every nonzero pair (distinct outputs)
                        hs, ls = np.flatnonzero(hi_nz[j]), np.flatnonzero(lo_nz[j])
                        aa, vv = _word(hi[j, hs])[:, None], _word(lo[j, ls])[None, :]
                        idx = (hs[:, None] * 128 + ls[None, :]).reshape(-1)
                        acc[0][idx] += (aa * _bf16(vv * qh[j])).reshape(-1)
                        acc[1][idx] += (aa * _bf16(vv * ql[j])).reshape(-1)
                    start = j + 1
                partial[s, c, h0:h0 + hw] = (acc[0] + acc[1]).reshape(hw, 128)
    out = np.zeros((n_sub, row_hi, 128), np.float32)
    for c in range(n_chunks):
        out = out + partial[:, c]
    return out


def emulate_dot_build(q, rowid, row_hi, live=None, chunk=T.DOT_CHUNK):
    """The build-form dot kernel's walk: a thread per row over the row's
    entries of :func:`row_order`, a chunk's halves added at its end, the
    chunks' sums in order."""
    row_ptr, entry_of = (t.numpy() for t in T.row_order(
        torch.from_numpy(rowid), row_hi, None if live is None else torch.from_numpy(live)))
    q = np.asarray(q, np.float32)
    n_sub, rows = q.shape[0], row_hi * 128
    out = np.zeros((n_sub, rows), np.float32)
    for s in range(n_sub):
        ents = entry_of[s, :row_ptr[s, -1]].astype(np.int64)
        row = np.repeat(np.arange(rows), np.diff(row_ptr[s]))
        grp_key = row * (1 << 20) + ents // chunk  # (row, chunk), in walk order
        grp, first = np.unique(grp_key, return_index=True)
        gid = np.searchsorted(grp, grp_key)
        x = q[s, ents]
        xh = _bf16(x)
        xl = _bf16(x - xh)
        acc_h = np.zeros(len(grp), np.float32)
        acc_l = np.zeros(len(grp), np.float32)
        np.add.at(acc_h, gid, xh)
        np.add.at(acc_l, gid, xl)
        np.add.at(out[s], row[first], acc_h + acc_l)  # chunks ascending within a row
    return out.reshape(n_sub, row_hi, 128)


def emulate_mult_premat(mult3, oh_hi, oh_lo, wi=0):
    """The premat mult kernel's arithmetic ([n_sub, n_pad])."""
    hi_b, lo_b = _window(oh_hi, oh_lo, wi)
    m = np.asarray(mult3, np.float32)
    m_hi = _bf16(m)
    m_lo = _bf16(m - m_hi)
    n_sub, n_pad, row_hi = hi_b.shape
    u = np.zeros((n_sub, n_pad), np.float32)
    for s in range(n_sub):
        hi_nz, lo_nz = _nonzero(hi_b[s]), _nonzero(lo_b[s])
        hc, lc = hi_nz.sum(1), lo_nz.sum(1)
        simple = np.flatnonzero((hc == 1) & (lc == 1))
        h = hi_nz[simple].argmax(1)
        l = lo_nz[simple].argmax(1)
        a = _word(hi_b[s, simple, h])
        v = _word(lo_b[s, simple, l])
        u[s, simple] = np.float32(0.0) + (a * m_hi[s, h, l] + a * m_lo[s, h, l]) * v
        for e in np.flatnonzero((hc > 0) & (lc > 0) & ~((hc == 1) & (lc == 1))):
            acc = np.float32(0.0)
            hs = np.flatnonzero(hi_nz[e])
            for col in np.flatnonzero(lo_nz[e]):
                ph = pl = np.float32(0.0)
                for hh in hs:
                    aa = _word(hi_b[s, e, hh])
                    ph = ph + aa * m_hi[s, hh, col]
                    pl = pl + aa * m_lo[s, hh, col]
                acc = acc + (ph + pl) * _word(lo_b[s, e, col])
            u[s, e] = acc
    return u


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _inputs(seed, n_win, n_sub, n, row_hi, live=None, zero_q=False):
    """Row ids, q and mult3 made with numpy. With ``live``, a share of the
    slots is padding as the layout makes it: row 0 and value 0 (so q = 0)."""
    rng = np.random.default_rng(seed)
    rowid = rng.integers(0, row_hi * 128, (n_win, n_sub, n)).astype(np.int16)
    q = rng.normal(size=(n_win, n_sub, n)).astype(np.float32)
    lv = np.ones((n_win, n_sub, n), bool)
    if live is not None:
        lv = rng.random((n_win, n_sub, n)) < live
        rowid[~lv] = 0
        q[~lv] = 0.0
    if zero_q:  # the first SGD step from a zero coefficient
        q[:] = 0.0
    m3 = rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)
    return rowid, q, lv, m3


def _dot_tolerance(q, rowid, row_hi):
    n_sub = q.shape[0]
    absum = np.zeros((n_sub, row_hi * 128))
    for s in range(n_sub):
        np.add.at(absum[s], rowid[s].astype(np.int64), np.abs(q[s]))
    return 1e-5 * absum.reshape(n_sub, row_hi, 128) + 1e-6


def _general(oh_hi, oh_lo, seed):
    """One-hot stacks with a second nonzero (a value not 1) in about a tenth
    of the rows of each, and values not 1 in place of some ones."""
    rng = np.random.default_rng(seed)
    out = []
    for oh in (oh_hi, oh_lo):
        a = oh.float().numpy().copy()
        w = a.shape[-1]
        lead = a.shape[:-1]
        pick = rng.random(lead) < 0.1
        col = rng.integers(0, w, lead)
        val = rng.choice(np.array([-2.5, 0.75, 3.0, -1.0], np.float32), lead)
        np.put_along_axis(a, col[..., None], np.where(pick, val, np.take_along_axis(a, col[..., None], -1)[..., 0])[..., None], -1)
        scale = rng.random(lead) < 0.05
        a[scale] *= np.float32(-1.5)
        out.append(torch.from_numpy(a).to(torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# the dot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_hi", (1, 4, 128, 130))
@pytest.mark.parametrize("n", (1, 1000, 8192 + 7, 20000))
def test_premat_dot_order_equals_the_build_forms_walk_and_the_jax_kernel(row_hi, n):
    n_sub = 2
    rowid, q, lv, _ = _inputs(n + row_hi, 1, n_sub, n, row_hi, live=0.575)
    rowid, q, lv = rowid[0], q[0], lv[0]
    oh_hi, oh_lo = T.premat_row_onehots(torch.from_numpy(rowid), row_hi)
    got = emulate_dot_premat(q, oh_hi, oh_lo)
    np.testing.assert_array_equal(got, emulate_dot_build(q, rowid, row_hi, live=lv))
    np.testing.assert_array_equal(got, emulate_dot_build(q, rowid, row_hi))  # padding: q = 0
    tol = _dot_tolerance(q, rowid, row_hi)
    ref = np.asarray(J.dot_crossing_premat_pallas(
        jnp.asarray(q), jnp.asarray(oh_hi.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(oh_lo.float().numpy()).astype(jnp.bfloat16), interpret=True))
    assert np.all(np.abs(got - ref) <= tol)
    assert np.all(np.abs(got - T.dot_crossing_premat_plain(torch.from_numpy(q), oh_hi, oh_lo).numpy()) <= tol)


@pytest.mark.parametrize("n_win", (1, 3))
@pytest.mark.parametrize("row_hi,n", ((4, 8192 + 7), (130, 1000)))
def test_premat_dot_selects_the_window(n_win, row_hi, n):
    rowid, q, lv, _ = _inputs(11 + n_win, n_win, 2, n, row_hi, live=0.575)
    oh_hi, oh_lo = T.premat_row_onehots(torch.from_numpy(rowid), row_hi)
    for wi in range(n_win):
        got = emulate_dot_premat(q[wi], oh_hi, oh_lo, wi)
        np.testing.assert_array_equal(got, emulate_dot_build(q[wi], rowid[wi], row_hi, live=lv[wi]))
        ref = np.asarray(J.dot_crossing_premat_xla(
            jnp.asarray(q[wi]), jnp.asarray(oh_hi.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(oh_lo.float().numpy()).astype(jnp.bfloat16), wi))
        assert np.all(np.abs(got - ref) <= _dot_tolerance(q[wi], rowid[wi], row_hi))


def test_premat_dot_with_every_q_zero_is_zero():
    rowid, q, _, _ = _inputs(3, 1, 2, 20000, 128, zero_q=True)
    q = -q[0]  # -0 everywhere: still no live entry
    oh_hi, oh_lo = T.premat_row_onehots(torch.from_numpy(rowid[0]), 128)
    got = emulate_dot_premat(q, oh_hi, oh_lo)
    assert not got.any() and not np.signbit(got).any()
    np.testing.assert_array_equal(got, emulate_dot_build(q, rowid[0], 128))


@pytest.mark.parametrize("row_hi", (4, 130))
def test_premat_dot_general_rows_within_the_plain_versions_tolerance(row_hi):
    n = 5000
    rowid, q, _, _ = _inputs(21 + row_hi, 1, 2, n, row_hi, live=0.575)
    oh_hi, oh_lo = _general(*T.premat_row_onehots(torch.from_numpy(rowid[0]), row_hi), seed=row_hi)
    got = emulate_dot_premat(q[0], oh_hi, oh_lo)
    plain = T.dot_crossing_premat_plain(torch.from_numpy(q[0]), oh_hi, oh_lo).numpy()
    # Σ_e |a|·|v|·|q| per output bounds both orders' rounding
    n_pad = oh_hi.shape[1]
    qa = np.abs(np.pad(q[0], ((0, 0), (0, n_pad - n)))).astype(np.float64)
    mag = np.einsum("seh,sel->shl", np.abs(oh_hi.double().numpy()), np.abs(oh_lo.double().numpy()) * qa[..., None])
    assert np.all(np.abs(got - plain) <= 1e-5 * mag + 1e-6)
    general = ((_nonzero(_bits(oh_hi)).sum(-1) > 1) | (_nonzero(_bits(oh_lo)).sum(-1) > 1))[:, :n] & (q[0] != 0)
    assert general.sum() > 100  # the slow path is exercised


# ---------------------------------------------------------------------------
# the mult
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row_hi", (1, 4, 128, 130))
@pytest.mark.parametrize("n", (1, 1000, 8192 + 7, 20000))
def test_premat_mult_decode_is_bit_equal_to_the_plain_and_jax_forms(row_hi, n):
    n_win = 3 if n == 1000 else 1
    rowid, _, _, m3 = _inputs(n * 3 + row_hi, n_win, 2, n, row_hi, live=0.575)
    oh_hi, oh_lo = T.premat_row_onehots(torch.from_numpy(rowid), row_hi)
    j_hi = jnp.asarray(oh_hi.float().numpy()).astype(jnp.bfloat16)
    j_lo = jnp.asarray(oh_lo.float().numpy()).astype(jnp.bfloat16)
    for wi in range(n_win):
        got = emulate_mult_premat(m3, oh_hi, oh_lo, wi)
        np.testing.assert_array_equal(got, T.mult_crossing_premat_plain(torch.from_numpy(m3), oh_hi, oh_lo, wi).numpy())
        np.testing.assert_array_equal(got, np.asarray(J.mult_crossing_premat_xla(jnp.asarray(m3), j_hi, j_lo, wi)))
        np.testing.assert_array_equal(got[:, :n], T.mult_crossing_plain(torch.from_numpy(m3), torch.from_numpy(rowid[wi])).numpy())


@pytest.mark.parametrize("row_hi", (4, 130))
def test_premat_mult_general_rows_within_the_plain_versions_tolerance(row_hi):
    rowid, _, _, m3 = _inputs(31 + row_hi, 1, 2, 3000, row_hi, live=0.575)
    oh_hi, oh_lo = _general(*T.premat_row_onehots(torch.from_numpy(rowid[0]), row_hi), seed=row_hi + 1)
    got = emulate_mult_premat(m3, oh_hi, oh_lo)
    plain = T.mult_crossing_premat_plain(torch.from_numpy(m3), oh_hi, oh_lo).numpy()
    m_hi = _bf16(m3)
    m_lo = _bf16(m3 - m_hi)
    mag = np.einsum("seh,shl,sel->se", np.abs(oh_hi.double().numpy()),
                    np.abs(m_hi).astype(np.float64) + np.abs(m_lo), np.abs(oh_lo.double().numpy()))
    assert np.all(np.abs(got - plain) <= 1e-6 * mag)
    general = (_nonzero(_bits(oh_hi)).sum(-1) > 1) | (_nonzero(_bits(oh_lo)).sum(-1) > 1)
    assert general.sum() > 100
    simple = ~general
    np.testing.assert_array_equal(got[simple], plain[simple])
