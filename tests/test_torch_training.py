"""The port's wide-sparse training slice against the JAX package on the CPU:
the one-hot layout, the feature-side rounds, the four row crossings (plain
versions against the JAX XLA form and the Pallas kernels in interpret mode),
``onehot_batch_step``, ``SGD.optimize`` on the one-hot (premat on and off),
scatter and dense paths, and LogisticRegression fit → transform → save with
cross-package loading. Tests of the CUDA kernels are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- the mult crossings are bit-equal (one nonzero term per output);
- dot crossings: 1e-5 · Σ_row |q| + 1e-6 — the same split-bf16 terms summed
  in another order (f32, ~2^-24 per add);
- scatter round and one minibatch's gradient/loss: rtol 1e-5 (atol 1e-5
  for the scatter's few-term sums near 0) — the same terms in another order;
- fitted coefficients: rtol 1e-4, atol 1e-6 and loss histories rtol 1e-5
  after a few epochs of f32 SGD whose margins differ in their last bits.
The JAX side runs on a one-device mesh, so its local batch is the port's.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.linalg.onehot_sparse as J
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.iteration import DeviceDataCache as JCache
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.logistic_regression import (
    LogisticRegression as JLogisticRegression,
    LogisticRegressionModel as JLogisticRegressionModel,
)
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops import HingeLoss as JHingeLoss
from flink_ml_tpu.ops import LeastSquareLoss as JLeastSquareLoss
from flink_ml_tpu.ops import regularize as jregularize
from flink_ml_tpu.ops.schedule import chunked_schedule as jchunked, offset_schedule as joffset
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.lib import LogisticRegressionModelServable as JLRServable
from flink_ml_tpu.utils.arrays import group_ranks as jgroup_ranks, next_pow2 as jnext_pow2

import flink_ml_tpu_torch.linalg.onehot_sparse as T
from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.iteration import DeviceDataCache
from flink_ml_tpu_torch.linalg.vectors import SparseVector
from flink_ml_tpu_torch.models.classification.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, HingeLoss, LeastSquareLoss
from flink_ml_tpu_torch.ops.optimizer import SGD, regularize
from flink_ml_tpu_torch.ops.schedule import chunked_schedule, offset_schedule
from flink_ml_tpu_torch.servable import load_servable
from flink_ml_tpu_torch.utils import read_write as rw
from flink_ml_tpu_torch.utils.arrays import group_ranks, next_pow2

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CROSSINGS = (T.DOT_CROSSING, T.MULT_CROSSING, T.DOT_CROSSING_PREMAT, T.MULT_CROSSING_PREMAT)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sparse_data(seed, n, d, K, live=1.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) >= live] = 0.0  # padding slots
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = (0.5 + rng.random(n)).astype(np.float32)
    return idx, val, y, w


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


# ---------------------------------------------------------------------------
# host helpers and the layout
# ---------------------------------------------------------------------------


def test_array_helpers_and_schedules_match_the_jax_package():
    x = np.array([0, 1, 2, 3, 5, 64, 65, 1000])
    np.testing.assert_array_equal(next_pow2(x), jnext_pow2(x))
    keys = np.array([5, 5, 7, 9, 9, 9, 11])
    np.testing.assert_array_equal(group_ranks(keys), jgroup_ranks(keys))
    for m, lb, n in ((100, 32, 9), (64, 64, 3), (70, 16, 11)):
        for a, b in zip(offset_schedule(m, lb, n), joffset(m, lb, n)):
            np.testing.assert_array_equal(a, b)
        s, o = offset_schedule(m, lb, n)
        for a, b in zip(chunked_schedule(s, o, n, 4), jchunked(s, o, n, 4)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n,d,K,lb,sub_rows", [
    (700, 1000, 6, 256, 100),
    (512, 4096, 8, 128, 16384),
    (1000, 20000, 5, 333, 64),
])
def test_layout_and_plan_identical_to_the_jax_package(n, d, K, lb, sub_rows):
    idx, val, _, _ = _sparse_data(n + d, n, d, K, live=0.8)
    lay = T.OneHotSparseLayout.build(idx, val, d, lb, sub_rows=sub_rows)
    ref = J.OneHotSparseLayout.build(idx, val, d, 1, lb, sub_rows=sub_rows)
    assert lay.class_meta == ref.class_meta
    assert (lay.n_flat, lay.n_sub, lay.n_windows, lay.sub_batch, lay.row_hi) == (
        ref.n_flat, ref.n_sub, ref.n_windows, ref.sub_batch, ref.row_hi)
    assert lay.window_starts == ref.window_starts and lay.local_batch == ref.local_batch
    np.testing.assert_array_equal(lay.perm, ref.perm)
    np.testing.assert_array_equal(lay.inv_perm, ref.inv_perm)
    for name in ("lidx", "rowid", "lvals"):
        a, b = getattr(lay, name), getattr(ref, name)[0, 0]
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    coef = np.random.default_rng(1).normal(size=d).astype(np.float32)
    np.testing.assert_array_equal(lay.permute_coef(coef), ref.permute_coef(coef))
    np.testing.assert_array_equal(lay.unpermute_coef(lay.permute_coef(coef)), coef)
    assert T.premat_bytes(lay.n_windows * lay.n_sub, lay.n_flat, lay.row_hi) == J.premat_bytes(
        ref.n_windows * ref.n_sub, ref.n_flat, ref.row_hi)


def test_layout_rejects_what_the_jax_package_rejects():
    with pytest.raises(ValueError, match="out of range"):
        T.OneHotSparseLayout.build(np.array([[0, 99]], np.int32), np.ones((1, 2), np.float32), 50, 1)
    with pytest.raises(ValueError, match="no nonzero"):
        T.OneHotSparseLayout.build(np.zeros((4, 2), np.int32), np.zeros((4, 2), np.float32), 10, 4)
    with pytest.raises(ValueError, match="packed rowid"):
        T.OneHotSparsePlan.from_max_counts(np.ones(4, np.int64), 512, 40000)
    assert T.OneHotSparseLayout.build(
        np.zeros((4, 2), np.int32), np.ones((4, 2), np.float32), 10, 4, max_stack_bytes=1) is None


# ---------------------------------------------------------------------------
# feature-side rounds
# ---------------------------------------------------------------------------


def _layout(seed=2, n=700, d=1000, K=6, lb=256, sub_rows=100):
    idx, val, y, w = _sparse_data(seed, n, d, K, live=0.8)
    return T.OneHotSparseLayout.build(idx, val, d, lb, sub_rows=sub_rows), (idx, val, y, w)


def test_gather_and_scatter_rounds_match_the_jax_package():
    lay, _ = _layout()
    rng = np.random.default_rng(3)
    coef_perm = rng.normal(size=lay.nblk * T.BLOCK).astype(np.float32)
    for wi in range(lay.n_windows):
        lidx = lay.lidx[wi]
        g = T.gather_round(_t(coef_perm), _t(lidx), lay.class_meta).numpy()
        g_ref = np.asarray(J.gather_round(jnp.asarray(coef_perm), jnp.asarray(lidx, jnp.int32), lay.class_meta))
        np.testing.assert_array_equal(g, g_ref)  # exact: one nonzero term per slot
        u = rng.normal(size=lidx.shape).astype(np.float32)
        s = T.scatter_round(_t(u), _t(lidx), lay.class_meta, lay.nblk).numpy()
        s_ref = np.asarray(J.scatter_round(jnp.asarray(u), jnp.asarray(lidx, jnp.int32), lay.class_meta, lay.nblk))
        np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5)


def test_scatter_round_is_deterministic_at_every_chunk_size(monkeypatch):
    lay, _ = _layout()
    u = np.random.default_rng(4).normal(size=lay.lidx[0].shape).astype(np.float32)
    whole = T.scatter_round(_t(u), _t(lay.lidx[0]), lay.class_meta, lay.nblk)
    assert torch.equal(T.scatter_round(_t(u), _t(lay.lidx[0]), lay.class_meta, lay.nblk), whole)
    monkeypatch.setattr(T, "_SCATTER_CHUNK_ELEMS", 1)  # one block per chunk
    chunked = T.scatter_round(_t(u), _t(lay.lidx[0]), lay.class_meta, lay.nblk)
    assert torch.equal(T.scatter_round(_t(u), _t(lay.lidx[0]), lay.class_meta, lay.nblk), chunked)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the four crossings: plain versions against the JAX XLA and Pallas forms
# ---------------------------------------------------------------------------


def _crossing_inputs(seed, n_sub, n, row_hi):
    rng = np.random.default_rng(seed)
    rhi = rng.integers(0, row_hi, (n_sub, n)).astype(np.int32)
    rlo = rng.integers(0, 128, (n_sub, n)).astype(np.int32)
    rowid = (rhi * 128 + rlo).astype(np.int16)
    q = rng.normal(size=(n_sub, n)).astype(np.float32)
    m3 = rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)
    return rhi, rlo, rowid, q, m3


def _dot_tolerance(q, rowid, row_hi):
    """1e-5 · Σ_row |q| + 1e-6 per output row."""
    n_sub = q.shape[0]
    absum = np.zeros((n_sub, row_hi * 128))
    for s in range(n_sub):
        np.add.at(absum[s], rowid[s].astype(np.int64), np.abs(q[s]))
    return 1e-5 * absum.reshape(n_sub, row_hi, 128) + 1e-6


@pytest.mark.parametrize("n_sub,n,row_hi", [(1, 1, 1), (3, 1000, 4), (2, 5000, 4), (1, 300, 128)])
def test_crossing_plain_versions_match_the_jax_xla_form(n_sub, n, row_hi):
    rhi, rlo, rowid, q, m3 = _crossing_inputs(n + row_hi, n_sub, n, row_hi)
    dot = T.dot_crossing(_t(q), _t(rowid), row_hi).numpy()
    dot_ref = np.asarray(J.dot_crossing_xla(jnp.asarray(q), jnp.asarray(rhi), jnp.asarray(rlo), row_hi))
    assert np.all(np.abs(dot - dot_ref) <= _dot_tolerance(q, rowid, row_hi))
    mult = T.mult_crossing(_t(m3), _t(rowid)).numpy()
    mult_ref = np.asarray(J.mult_crossing_xla(jnp.asarray(m3), jnp.asarray(rhi), jnp.asarray(rlo), row_hi))
    np.testing.assert_array_equal(mult, mult_ref)  # bit-equal


def test_crossing_plain_versions_match_the_pallas_kernels_in_interpret_mode():
    n_sub, n, row_hi = 2, 3000, 4
    rhi, rlo, rowid, q, m3 = _crossing_inputs(7, n_sub, n, row_hi)
    jq, jhi, jlo, jm3 = jnp.asarray(q), jnp.asarray(rhi), jnp.asarray(rlo), jnp.asarray(m3)
    tol = _dot_tolerance(q, rowid, row_hi)
    dot = T.dot_crossing(_t(q), _t(rowid), row_hi).numpy()
    ref = np.asarray(J.dot_crossing_pallas(jq, jhi, jlo, row_hi, interpret=True))
    assert np.all(np.abs(dot - ref) <= tol)
    np.testing.assert_array_equal(
        T.mult_crossing(_t(m3), _t(rowid)).numpy(),
        np.asarray(J.mult_crossing_pallas(jm3, jhi, jlo, row_hi, interpret=True)),
    )
    oh = T.premat_row_onehots(_t(rowid), row_hi)
    joh = J.premat_row_onehots(jnp.asarray(rowid), row_hi)
    pdot = T.dot_crossing_premat(_t(q), *oh).numpy()
    pref = np.asarray(J.dot_crossing_premat_pallas(jq, *joh, interpret=True))
    assert np.all(np.abs(pdot - pref) <= tol)
    np.testing.assert_array_equal(
        T.mult_crossing_premat(_t(m3), *oh).numpy(),
        np.asarray(J.mult_crossing_premat_pallas(jm3, *joh, interpret=True)),
    )


@pytest.mark.parametrize("n", [5000, 4096, 37])
def test_premat_onehots_and_crossings_match_the_jax_package(n):
    n_sub, row_hi, n_win = 2, 4, 3
    rng = np.random.default_rng(n)
    rowid = rng.integers(0, row_hi * 128, (n_win, n_sub, n)).astype(np.int16)
    rowid[0, 0, :3] = [-1, row_hi * 128, 5]  # out of the row space: an all-zero oh_hi row
    oh_hi, oh_lo = T.premat_row_onehots(_t(rowid), row_hi)
    joh_hi, joh_lo = J.premat_row_onehots(jnp.asarray(rowid), row_hi)
    assert oh_hi.dtype == torch.bfloat16 and tuple(oh_hi.shape) == joh_hi.shape
    np.testing.assert_array_equal(oh_hi.float().numpy(), np.asarray(joh_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(oh_lo.float().numpy(), np.asarray(joh_lo.astype(jnp.float32)))
    q = rng.normal(size=(n_sub, n)).astype(np.float32)
    m3 = rng.normal(size=(n_sub, row_hi, 128)).astype(np.float32)
    for wi in range(n_win):
        dot = T.dot_crossing_premat(_t(q), oh_hi, oh_lo, wi).numpy()
        ref = np.asarray(J.dot_crossing_premat_xla(jnp.asarray(q), joh_hi, joh_lo, wi))
        np.testing.assert_allclose(dot, ref, rtol=1e-6, atol=1e-6)
        mult = T.mult_crossing_premat(_t(m3), oh_hi, oh_lo, wi).numpy()
        np.testing.assert_array_equal(
            mult, np.asarray(J.mult_crossing_premat_xla(jnp.asarray(m3), joh_hi, joh_lo, wi)))
        # the port's own contract: build form == premat form, bit for bit
        build = T.dot_crossing(_t(q), _t(rowid[wi]), row_hi)
        assert torch.equal(build, torch.from_numpy(dot))
        assert torch.equal(T.mult_crossing(_t(m3), _t(rowid[wi])), torch.from_numpy(mult[:, :n]))


def test_row_order_lists_each_rows_live_entries_in_ascending_order():
    rng = np.random.default_rng(9)
    row_hi, n = 2, 400
    rowid = rng.integers(-2, row_hi * 128 + 2, (2, n)).astype(np.int16)
    live = rng.random((2, n)) > 0.3
    row_ptr, entry_of = T.row_order(_t(rowid), row_hi, live=_t(live))
    assert row_ptr.dtype == torch.int32 and entry_of.dtype == torch.int32
    for s in range(2):
        for r in range(row_hi * 128):
            got = entry_of[s, row_ptr[s, r]:row_ptr[s, r + 1]].numpy()
            want = np.flatnonzero((rowid[s] == r) & live[s])
            np.testing.assert_array_equal(got, want)


def test_crossing_kernels_are_registered_and_point_at_pallas_calls():
    jax_src = (REPO / "flink_ml_tpu/linalg/onehot_sparse.py").read_text().splitlines()
    for kernel in CROSSINGS:
        assert kernel in native.KERNELS
        assert kernel.source_path == "flink_ml_tpu_torch/csrc/onehot_crossing.cu"
        assert (native.CSRC_DIR / kernel.source).is_file()
        path, line = kernel.replaces.split(":")
        assert path == "flink_ml_tpu/linalg/onehot_sparse.py"
        assert "pl.pallas_call(" in jax_src[int(line) - 1], kernel.replaces
        assert kernel.symbol in (native.CSRC_DIR / kernel.source).read_text()


def test_crossing_wrappers_take_plain_versions_only_for_cpu_tensors(monkeypatch):
    _, _, rowid, q, m3 = _crossing_inputs(5, 1, 50, 1)
    calls = []
    for name in ("dot_crossing_premat_plain", "mult_crossing_premat_plain"):
        real = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    before = [k.launches for k in CROSSINGS]
    T.dot_crossing(_t(q), _t(rowid), 1)
    T.mult_crossing(_t(m3), _t(rowid))
    assert calls == ["dot_crossing_premat_plain", "mult_crossing_premat_plain"]
    assert [k.launches for k in CROSSINGS] == before  # the CPU never counts a launch
    with pytest.raises(RuntimeError, match="needs CPU or CUDA"):
        T.mult_crossing(_t(m3).to("meta"), _t(rowid))


# ---------------------------------------------------------------------------
# one minibatch and the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("premat", [False, True])
def test_onehot_batch_step_matches_the_jax_package(premat):
    lay, (idx, val, y, w) = _layout()
    coef = np.random.default_rng(6).normal(size=1000).astype(np.float32)
    cp = lay.permute_coef(coef)
    pad = lay.n_sub * lay.sub_batch - lay.local_batch
    oh = T.premat_row_onehots(_t(lay.rowid), lay.row_hi)
    joh = J.premat_row_onehots(jnp.asarray(lay.rowid), lay.row_hi)
    for wi, w0 in enumerate(lay.window_starts):
        rows = slice(w0, w0 + lay.local_batch)
        yb, wb = np.pad(y[rows], (0, pad)), np.pad(w[rows], (0, pad))
        grad, loss, wsum = T.onehot_batch_step(
            _t(cp), _t(lay.lidx[wi]), _t(lay.rowid[wi]), _t(lay.lvals[wi]), _t(yb), _t(wb),
            BinaryLogisticLoss.INSTANCE, lay.class_meta, lay.nblk, lay.sub_batch,
            lay.row_hi, premat=(*oh, wi) if premat else None,
        )
        jgrad, jloss, jwsum = J.onehot_batch_step(
            jnp.asarray(cp), jnp.asarray(lay.lidx[wi]), jnp.asarray(lay.rowid[wi]),
            jnp.asarray(lay.lvals[wi]), jnp.asarray(yb), jnp.asarray(wb),
            JBinaryLogisticLoss.INSTANCE, lay.class_meta, lay.nblk, lay.sub_batch,
            lay.row_hi, use_pallas=False, premat=(*joh, wi) if premat else None,
        )
        np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(wsum), float(jwsum), rtol=1e-6)


def test_loss_functions_and_regularize_match_the_jax_package():
    rng = np.random.default_rng(8)
    dot = rng.normal(size=64).astype(np.float32) * 4
    y = (rng.random(64) > 0.5).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    for port, ref in ((BinaryLogisticLoss.INSTANCE, JBinaryLogisticLoss.INSTANCE),
                      (HingeLoss.INSTANCE, JHingeLoss.INSTANCE),
                      (LeastSquareLoss.INSTANCE, JLeastSquareLoss.INSTANCE)):
        loss, mult = port.loss_and_mult(_t(dot), _t(y), _t(w))
        jloss, jmult = ref.loss_and_mult(jnp.asarray(dot), jnp.asarray(y), jnp.asarray(w))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        np.testing.assert_allclose(mult.numpy(), np.asarray(jmult), rtol=1e-6, atol=1e-7)
    coef = rng.normal(size=32).astype(np.float32)
    for reg, en in ((0.0, 0.0), (0.1, 0.0), (0.1, 1.0), (0.1, 0.3)):
        new, loss = regularize(_t(coef), reg, en, 0.5)
        jnew, jloss = jregularize(jnp.asarray(coef), reg, en, 0.5)
        np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def _fit_pair(cols, d, port_kw, jax_kw, sgd_kw, ctx):
    port = SGD(device="cpu", **sgd_kw, **port_kw)
    coef = port.optimize(np.zeros(d, np.float32), dict(cols), BinaryLogisticLoss.INSTANCE)
    ref = JSGD(ctx=ctx, **sgd_kw, **jax_kw)
    jcoef = ref.optimize(np.zeros(d, np.float32), JCache(dict(cols), ctx=ctx), JBinaryLogisticLoss.INSTANCE)
    return (coef, port), (np.asarray(jcoef), ref)


SGD_KW = dict(max_iter=9, global_batch_size=128, tol=0.0, learning_rate=0.3, reg=0.01, elastic_net=0.5)


@pytest.mark.parametrize("kernel,premat", [("onehot", "on"), ("onehot", "off"), ("scatter", "auto")])
def test_sparse_sgd_matches_the_jax_package(one_device_mesh, kernel, premat):
    idx, val, y, _ = _sparse_data(43, 600, 900, 8)
    cols = {"indices": idx, "values": val, "labels": y, "weights": np.ones(600, np.float32)}
    kw = dict(sparse_kernel=kernel, onehot_premat=premat)
    (coef, port), (jcoef, ref) = _fit_pair(cols, 900, kw, kw, SGD_KW, one_device_mesh)
    assert port.onehot_premat_active == ref.onehot_premat_active == (premat == "on")
    np.testing.assert_allclose(coef, jcoef, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.loss_history, ref.loss_history, rtol=1e-5)
    assert len(port.loss_history) == SGD_KW["max_iter"]


def test_onehot_premat_on_and_off_are_bit_identical():
    idx, val, y, _ = _sparse_data(44, 700, 1500, 8, live=0.9)
    cache = DeviceDataCache(
        {"indices": idx, "values": val, "labels": y, "weights": np.ones(700, np.float32)}, device="cpu")
    coefs = []
    for premat in ("on", "off", "on"):
        sgd = SGD(device="cpu", sparse_kernel="onehot", onehot_premat=premat, **SGD_KW)
        coefs.append(sgd.optimize(np.zeros(1500, np.float32), cache, BinaryLogisticLoss.INSTANCE))
        assert sgd.onehot_premat_active == (premat == "on")
        assert (cache._onehot_premat_memo is not None) == (premat == "on")
    np.testing.assert_array_equal(coefs[0], coefs[1])
    np.testing.assert_array_equal(coefs[0], coefs[2])


def test_dense_sgd_with_tol_matches_the_jax_package(one_device_mesh):
    rng = np.random.default_rng(45)
    X = rng.normal(size=(300, 12)).astype(np.float32)
    y = (X @ rng.normal(size=12) > 0).astype(np.float32)
    cols = {"features": X, "labels": y, "weights": np.ones(300, np.float32)}
    kw = dict(max_iter=200, global_batch_size=64, tol=0.2, learning_rate=0.5)
    (coef, port), (jcoef, ref) = _fit_pair(cols, 12, {}, {}, kw, one_device_mesh)
    assert len(port.loss_history) == len(ref.loss_history) < 200  # tol stopped both, same epoch
    np.testing.assert_allclose(coef, jcoef, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port.loss_history, ref.loss_history, rtol=1e-5)


def test_sgd_rejects_what_is_not_ported(monkeypatch):
    with pytest.raises(ValueError, match="sparse_kernel"):
        SGD(sparse_kernel="dense")
    with pytest.raises(ValueError, match="onehot_premat"):
        SGD(onehot_premat="maybe")
    cols = {"features": np.zeros((4, 2), np.float32), "labels": np.zeros(4, np.float32)}
    # streamed fits are ported (queue A 7): what is neither a cache nor columns is refused
    with pytest.raises(TypeError, match="a DeviceDataCache, a host-tier cache or a dict of columns"):
        SGD(device="cpu").optimize(np.zeros(2), object(), BinaryLogisticLoss.INSTANCE)
    with pytest.raises(ValueError, match="dense features"):
        SGD(device="cpu", sparse_kernel="onehot").optimize(np.zeros(2), cols, BinaryLogisticLoss.INSTANCE)
    monkeypatch.setenv(Options.TRAIN_MESH.env_var, "2")
    assert config.get(Options.TRAIN_MESH) == 2
    # the sharded tier is ported: a mesh of 2 needs a world of 2 ranks
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        SGD(device="cpu").optimize(np.zeros(2), cols, BinaryLogisticLoss.INSTANCE)
    # tensor parallelism is too: a 2 x 2 mesh needs a world of 4 ranks
    monkeypatch.setenv(Options.TRAIN_MESH_MODEL.env_var, "2")
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        SGD(device="cpu").optimize(np.zeros(2), cols, BinaryLogisticLoss.INSTANCE)


def test_training_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    cols = {"features": np.zeros((4, 2), np.float32), "labels": np.zeros(4, np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGD().optimize(np.zeros(2), cols, BinaryLogisticLoss.INSTANCE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDataCache(cols)
    df = DataFrame.from_dict({"features": np.zeros((4, 2)), "label": np.zeros(4)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogisticRegression().fit(df)


# ---------------------------------------------------------------------------
# LogisticRegression: fit → transform → save, across the two packages
# ---------------------------------------------------------------------------

N, D, NNZ, BATCH = 8192, 1 << 14, 8, 1024


@pytest.fixture(scope="module")
def sparse_frames():
    """d = 2^14, 8192 rows of 8 unique features: indices.size = 2^16, the
    least that SGD's 'auto' gate sends down the one-hot path (8 windows)."""
    rng = np.random.default_rng(46)
    rows = [np.sort(rng.choice(D, NNZ, replace=False)) for _ in range(N)]
    vals = rng.normal(size=(N, NNZ))
    w_true = rng.normal(size=D)
    y = np.array([float(vals[i] @ w_true[r] > 0) for i, r in enumerate(rows)])
    port = DataFrame.from_dict({"features": [SparseVector(D, r, v) for r, v in zip(rows, vals)], "label": y})
    ref = JDataFrame.from_dict({"features": [JSparseVector(D, r, v) for r, v in zip(rows, vals)], "label": y})
    return port, ref


@pytest.fixture(scope="module")
def fitted(sparse_frames):
    port_df, ref_df = sparse_frames
    est = LogisticRegression().set_max_iter(10).set_global_batch_size(BATCH).set_learning_rate(0.5).set_tol(0.0)
    model = est.fit(port_df, device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jest = (JLogisticRegression().set_max_iter(10).set_global_batch_size(BATCH)
                .set_learning_rate(0.5).set_tol(0.0))
        jmodel = jest.fit(ref_df)
    return est, model, jest, jmodel


def test_logistic_regression_fit_matches_the_jax_package(fitted):
    est, model, jest, jmodel = fitted
    assert est.onehot_premat_active  # the auto gate chose the one-hot path, premat form
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    np.testing.assert_allclose(model.coefficient, np.asarray(jmodel.coefficient), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(est.loss_history, jest.loss_history, rtol=1e-5)
    assert est.loss_history[-1] < est.loss_history[0]


def test_fit_transform_save_load_across_packages(fitted, tmp_path):
    _, model, _, jmodel = fitted
    X = np.random.default_rng(47).normal(size=(33, D))
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_allclose(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction")),
                               rtol=1e-5, atol=1e-6)

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    model.save(port_dir)
    jmodel.save(jax_dir)
    loaded = rw.load_stage(jax_dir)  # a JAX-written directory, through the class table
    assert isinstance(loaded, LogisticRegressionModel)
    np.testing.assert_array_equal(loaded.coefficient, jmodel.coefficient)
    assert loaded.param_map_to_json() == jmodel.param_map_to_json()
    assert isinstance(LogisticRegressionModel.load(port_dir), LogisticRegressionModel)
    jloaded = JLogisticRegressionModel.load_servable(port_dir)  # the port's directory in JAX
    assert isinstance(jloaded, JLRServable)
    np.testing.assert_array_equal(jloaded.coefficient, model.coefficient)
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    a = loaded.transform(df, device="cpu")
    b = load_servable(port_dir).transform(df, device="cpu")
    c = jloaded.transform(jdf)
    d = jmodel.transform(jdf)
    for col in ("prediction", "rawPrediction"):
        np.testing.assert_array_equal(np.asarray(c.column(col)), np.asarray(d.column(col)))
        np.testing.assert_allclose(a.column(col), np.asarray(d.column(col)), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(b.column(col), model.transform(df, device="cpu").column(col))
    with pytest.raises(ValueError, match="does not match"):
        LogisticRegressionModel.load(str(_saved_other(tmp_path)))


def test_one_class_table_resolves_servable_and_stage():
    name = "flink_ml_tpu.models.classification.logistic_regression.LogisticRegressionModel"
    from flink_ml_tpu_torch.servable import LogisticRegressionModelServable

    assert rw.resolve_class(name) is LogisticRegressionModelServable
    assert rw.resolve_class(name, stage=True) is LogisticRegressionModel
    # a servable's saved name has no training-side stage
    with pytest.raises(ValueError, match="no port stage"):
        rw.resolve_class("flink_ml_tpu.servable.lib.StandardScalerModelServable", stage=True)


def _saved_other(tmp_path):
    path = tmp_path / "other"
    from flink_ml_tpu_torch.servable import StandardScalerModelServable

    rw.save_metadata(StandardScalerModelServable(), str(path))
    return path


def test_sparse_transform_is_not_ported(fitted, sparse_frames, monkeypatch):
    """Sparse features are not ported through a dense detour: the fitted
    model's transform of SparseVector rows runs on their packed triple (a
    ``DataFrame.vectors`` call would fail the test) and equals the JAX
    model's — predictions equal, rawPrediction within the sparse head's
    ulp envelope (the margins are bit-equal; the sigmoids may round apart)."""
    from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff

    _, model, _, jmodel = fitted
    port_df, ref_df = (f.take(np.arange(64)) for f in sparse_frames)
    ref = jmodel.transform(ref_df)

    def refuse(self, name):
        raise AssertionError(f"DataFrame.vectors({name!r}) densified a column")

    monkeypatch.setattr(DataFrame, "vectors", refuse)
    out = model.transform(port_df, device="cpu")
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))
    assert ulp_diff(out.column("rawPrediction"), np.asarray(ref.column("rawPrediction"))) <= (
        ULP_ENVELOPE["sparse_idf_logistic"]
    )


def test_training_modules_import_neither_jax_nor_the_jax_package():
    roots = set()
    for rel in ("ops/optimizer.py", "ops/lossfunc.py", "linalg/onehot_sparse.py",
                "iteration/datacache.py", "models/linear.py", "models/common.py",
                "models/classification/logistic_regression.py"):
        tree = ast.parse((REPO / "flink_ml_tpu_torch" / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flink_ml_tpu"}
