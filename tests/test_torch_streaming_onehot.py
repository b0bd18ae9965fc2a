"""The port's streamed sparse SGD on the one-hot crossings against the JAX
package on the CPU: the north-star shape (wide sparse rows streamed from a
host-tier cache through the crossings). One counting pass over the cache
(``streamed_onehot_plan``) sizes one ``OneHotSparsePlan`` for every window;
each window's stacks are filled on the host against it
(``_OneHotWindowStream``) and the resident one-hot epoch runs on them, the
premat crossings or the build form's.

It mirrors the JAX package's ``tests/test_streaming_onehot.py`` (the mesh
compositions are in ``test_torch_streaming.py``'s worlds) and the streamed
cases of ``tests/test_onehot_sparse.py`` and ``tests/test_sparse.py``. The
JAX side runs on a one-device mesh with its crossings in their XLA form (the
port's CPU tensors take the plain versions of the same arithmetic).

Tolerances, each with its source:
- against the JAX streamed one-hot fit: coefficients rtol 1e-4 / atol 1e-6,
  losses rtol 1e-5 (``tests/test_torch_training.py``);
- premat against build: bit for bit (the crossings' premat/build identity);
- streamed against the port's resident one-hot fit on batch-aligned rows:
  rtol 1e-4 / atol 1e-6 and losses rtol 1e-5 — the streamed plan counts
  the same units as the resident layout here, so they agree to the bit,
  which the test records;
- one-hot against the streamed scatter path: rtol 1e-3 / atol 1e-5
  (JAX ``test_streaming_onehot.py:50``, split-bf16 crossings against exact
  f32 gathers);
- a resumed fit against its clean fit: bit for bit.
"""
import shutil

import numpy as np
import pytest
import torch

from flink_ml_tpu.iteration import HostDataCache as JHostDataCache
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops.optimizer import (
    _OneHotWindowStream as JOneHotWindowStream,
    streamed_onehot_plan as jstreamed_onehot_plan,
)
from flink_ml_tpu.parallel.mesh import MeshContext as JMeshContext, mesh_context

import flink_ml_tpu_torch.ops.optimizer as om
from flink_ml_tpu_torch.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration import HostDataCache
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, HingeLoss
from flink_ml_tpu_torch.ops.optimizer import SGD, _OneHotWindowStream, streamed_onehot_plan

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-5
SCATTER_RTOL, SCATTER_ATOL = 1e-3, 1e-5

KW = dict(max_iter=12, global_batch_size=128, tol=0.0, learning_rate=0.3)


def _sparse_data(n, d, K, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.15] = 0.0  # padding slots
    return {"indices": idx, "values": val, "labels": (rng.random(n) > 0.5).astype(np.float32)}


def _fill(cache, cols, chunk=40):
    n = len(cols["labels"])
    for a in range(0, n, chunk):
        cache.append({k: v[a:a + chunk] for k, v in cols.items()})
    cache.finish()
    return cache


def _port(cache, dim, loss=None, **kw):
    opt = SGD(device="cpu", **kw)
    return opt.optimize(np.zeros(dim, np.float32), cache, loss or BinaryLogisticLoss.INSTANCE), opt


def _jax(cache, dim, **kw):
    with mesh_context(JMeshContext(n_data=1, n_model=1)):
        opt = JSGD(**kw)
        return opt.optimize(np.zeros(dim, np.float32), cache, JBinaryLogisticLoss.INSTANCE), opt


@pytest.mark.parametrize("n_data, n_model, window, batch", [(1, 1, 32, 16), (2, 1, 32, 16), (2, 2, 64, 64),
                                                            (3, 1, 20, 16), (1, 4, 7, 7)])
def test_the_streamed_plan_equals_jax(n_data, n_model, window, batch):
    cols = _sparse_data(400, 1500, 5, seed=3)
    cache, jcache = _fill(HostDataCache(), cols), _fill(JHostDataCache(), cols)
    got = streamed_onehot_plan(cache, 400, n_data, window, batch, 1500, n_model)
    want = jstreamed_onehot_plan(jcache, 400, n_data, window, batch, 1500, n_model)
    assert got.class_meta == want.class_meta
    assert (got.n_flat, got.nblk_local, got.sub_batch, got.row_hi) == (want.n_flat, want.nblk_local,
                                                                       want.sub_batch, want.row_hi)
    for name in ("perm", "inv_perm", "width_of_pos", "owner_of_pos", "base_of_pos", "local_block_of_pos"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("premat", [False, True])
def test_each_window_holds_jax_s_stacks_and_rows(premat):
    """A rank's window (data shard k, model shard m) is JAX's window's
    ``[k, m]`` cell: stacks, labels, weights and mask; the device-built
    one-hots or row order are those of its rowid stacks."""
    from flink_ml_tpu_torch.linalg.onehot_sparse import premat_row_onehots, row_order

    cols = _sparse_data(300, 1200, 5, seed=4)
    cols["weights"] = np.random.default_rng(1).uniform(0.5, 2.0, 300).astype(np.float32)
    n_data, n_model, W, b = 2, 2, 48, 16
    m = -(-300 // n_data)
    cache = _fill(HostDataCache(), cols)
    plan = streamed_onehot_plan(cache, 300, n_data, W, b, 1200, n_model)
    import jax

    jctx = JMeshContext(devices=jax.devices()[:n_data * n_model], n_data=n_data, n_model=n_model)
    jplan = jstreamed_onehot_plan(_fill(JHostDataCache(), cols), 300, n_data, W, b, 1200, n_model)
    jstream = JOneHotWindowStream(_fill(JHostDataCache(), cols), jctx, jplan, W, b, 1, m, 300)

    class Rank:  # a rank's view of the mesh: its data and model index
        def __init__(self, k, mi):
            self.data_index, self.model_index, self.n_data, self.n_model = k, mi, n_data, n_model
            self.device = torch.device("cpu")

    for j in range(-(-m // W)):
        want = jstream.load(j)
        jstacks = [np.asarray(a) for a in want["stacks"]]
        for k in range(n_data):
            for mi in range(n_model):
                got = _OneHotWindowStream(cache, Rank(k, mi), plan, W, b, 1, premat, None).load(j)
                for name, arr in zip(("lidx", "rowid", "lvals"), jstacks):
                    np.testing.assert_array_equal(got[name].numpy(), arr[k, mi], err_msg=name)
                for name in ("labels", "weights", "__mask__"):
                    np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name])[k * W:(k + 1) * W])
                if premat:
                    for a, bb in zip(got["oh"], premat_row_onehots(got["rowid"], plan.row_hi)):
                        assert torch.equal(a, bb)
                else:
                    for a, bb in zip(got["order"], row_order(got["rowid"], plan.row_hi, live=got["lvals"] != 0)):
                        assert torch.equal(a, bb)


@pytest.mark.parametrize("premat", ["on", "off"])
def test_streamed_onehot_matches_jax_and_streamed_scatter(tmp_path, premat):
    cols = _sparse_data(512, 2000, 6, seed=1)
    cache = _fill(HostDataCache(memory_budget_bytes=2000, spill_dir=str(tmp_path)), cols)
    assert any("files" in e for e in cache._log), "the budget should force a spill"
    got, opt = _port(cache, 2000, stream_window_rows=32, sparse_kernel="onehot", onehot_premat=premat, **KW)
    assert opt.onehot_premat_active == (premat == "on")
    want, jopt = _jax(_fill(JHostDataCache(), cols), 2000, stream_window_rows=32, sparse_kernel="onehot",
                      onehot_premat=premat, **KW)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt.loss_history, jopt.loss_history, rtol=LOSS_RTOL)
    scatter, sopt = _port(cache, 2000, stream_window_rows=32, sparse_kernel="scatter", **KW)
    np.testing.assert_allclose(got, scatter, rtol=SCATTER_RTOL, atol=SCATTER_ATOL)
    assert len(opt.loss_history) == len(sopt.loss_history) == KW["max_iter"]
    np.testing.assert_allclose(opt.loss_history, sopt.loss_history, rtol=SCATTER_RTOL)


@pytest.mark.parametrize("loss", ["logistic", "hinge"])
def test_streamed_premat_equals_build_bit_for_bit(loss):
    cols = _sparse_data(600, 3000, 7, seed=12)
    cache = _fill(HostDataCache(), cols, chunk=70)
    lf = BinaryLogisticLoss.INSTANCE if loss == "logistic" else HingeLoss.INSTANCE
    kw = dict(KW, reg=0.01, elastic_net=0.3)
    on, o1 = _port(cache, 3000, lf, stream_window_rows=64, sparse_kernel="onehot", onehot_premat="on", **kw)
    off, o2 = _port(cache, 3000, lf, stream_window_rows=64, sparse_kernel="onehot", onehot_premat="off", **kw)
    np.testing.assert_array_equal(on, off)
    assert o1.loss_history == o2.loss_history


def test_streamed_onehot_matches_resident_onehot():
    cols = _sparse_data(512, 2000, 6, seed=2)
    want, resident = _port(dict(cols), 2000, sparse_kernel="onehot", **KW)
    got, streamed = _port(_fill(HostDataCache(), cols), 2000, stream_window_rows=32, sparse_kernel="onehot", **KW)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(streamed.loss_history, resident.loss_history, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got, want)  # the same units, the same plan: the same bits


def test_streamed_onehot_ragged_tail_matches_scatter_and_jax(tmp_path):
    cols = _sparse_data(400, 1500, 5, seed=3)
    cache = _fill(HostDataCache(memory_budget_bytes=1500, spill_dir=str(tmp_path)), cols)
    kw = dict(KW, global_batch_size=48)  # 400 rows do not divide into batches of 48
    got, opt = _port(cache, 1500, stream_window_rows=100, sparse_kernel="onehot", **kw)
    scatter, _ = _port(cache, 1500, stream_window_rows=100, sparse_kernel="scatter", **kw)
    np.testing.assert_allclose(got, scatter, rtol=SCATTER_RTOL, atol=SCATTER_ATOL)
    want, jopt = _jax(_fill(JHostDataCache(), cols), 1500, stream_window_rows=100, sparse_kernel="onehot", **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt.loss_history, jopt.loss_history, rtol=LOSS_RTOL)


def test_streamed_onehot_tol_stops_like_scatter_and_jax():
    cols = _sparse_data(512, 2000, 6, seed=4)
    cache = _fill(HostDataCache(), cols)
    kw = dict(stream_window_rows=32, max_iter=300, global_batch_size=512, tol=0.5, learning_rate=0.5)
    hists = {}
    for kernel in ("onehot", "scatter"):
        hists[kernel] = _port(cache, 2000, sparse_kernel=kernel, **kw)[1].loss_history
    assert len(hists["onehot"]) < 300, "tol should stop early"
    assert len(hists["onehot"]) == len(hists["scatter"])
    np.testing.assert_allclose(hists["onehot"], hists["scatter"], rtol=SCATTER_RTOL)
    _, jopt = _jax(_fill(JHostDataCache(), cols), 2000, sparse_kernel="onehot", **kw)
    assert len(jopt.loss_history) == len(hists["onehot"])
    np.testing.assert_allclose(hists["onehot"], jopt.loss_history, rtol=LOSS_RTOL)


@pytest.mark.parametrize("premat", ["on", "off"])
def test_streamed_onehot_checkpoint_resume(tmp_path, premat):
    cols = _sparse_data(512, 2000, 6, seed=5)
    cache = _fill(HostDataCache(), cols)
    kw = dict(KW, stream_window_rows=32, sparse_kernel="onehot", onehot_premat=premat)
    want, _ = _port(cache, 2000, **kw)
    ckdir = str(tmp_path / "ck")
    got, _ = _port(cache, 2000, checkpoint_manager=CheckpointManager(ckdir), checkpoint_interval=2, **kw)
    np.testing.assert_array_equal(got, want)
    steps = CheckpointManager(ckdir).all_steps()
    assert len(steps) >= 2, "expected several checkpoints"
    state = CheckpointManager(ckdir).restore(steps[-1])  # the logical, unpermuted coefficient
    at_step, _ = _port(cache, 2000, **dict(kw, max_iter=steps[-1]))
    np.testing.assert_array_equal(np.asarray(state["coef"]), at_step)
    shutil.rmtree(f"{ckdir}/ckpt-{steps[-1]}")
    resumed, _ = _port(cache, 2000, checkpoint_manager=CheckpointManager(ckdir), checkpoint_interval=2, **kw)
    np.testing.assert_array_equal(resumed, want)


def test_streamed_onehot_fingerprint_equals_jax(tmp_path):
    from flink_ml_tpu.checkpoint import CheckpointManager as JCheckpointManager

    cols = _sparse_data(256, 2000, 4, seed=6)
    kw = dict(KW, max_iter=4, stream_window_rows=32, sparse_kernel="onehot", checkpoint_interval=2)
    mgr, jmgr = CheckpointManager(str(tmp_path / "t")), JCheckpointManager(str(tmp_path / "j"))
    _port(_fill(HostDataCache(), cols), 2000, checkpoint_manager=mgr, **kw)
    _jax(_fill(JHostDataCache(), cols), 2000, checkpoint_manager=jmgr, **kw)
    assert mgr.fingerprint == jmgr.fingerprint
    assert mgr.all_steps() == jmgr.all_steps()


def test_streamed_auto_picks_onehot_for_wide_models(monkeypatch):
    calls = []
    orig = om.SGD._optimize_streaming_onehot
    monkeypatch.setattr(om.SGD, "_optimize_streaming_onehot",
                        lambda self, *a, **k: calls.append(1) or orig(self, *a, **k))
    n, d, K = 2048, 1 << 15, 32  # n·K = 2^16, d >= 2^14
    cache = _fill(HostDataCache(), _sparse_data(n, d, K, seed=6), chunk=256)
    coef, opt = _port(cache, d, stream_window_rows=256, max_iter=3, global_batch_size=512, tol=0.0)
    assert calls, "auto should take the one-hot path on the streamed route"
    assert np.all(np.isfinite(coef)) and opt.layout_seconds > 0


def test_streamed_auto_narrow_stays_on_scatter(monkeypatch):
    calls = []
    monkeypatch.setattr(om.SGD, "_optimize_streaming_onehot", lambda self, *a, **k: calls.append(1) or None)
    cache = _fill(HostDataCache(), _sparse_data(256, 500, 4, seed=7))
    _port(cache, 500, stream_window_rows=16, max_iter=2, global_batch_size=64, tol=0.0)
    assert not calls


def test_streamed_auto_falls_back_when_stacks_exceed_the_budget(monkeypatch):
    monkeypatch.setattr(om, "_hbm_bytes_limit", lambda device=None: 1 << 16)
    n, d, K = 2048, 1 << 15, 32
    cols = _sparse_data(n, d, K, seed=8)
    cache = _fill(HostDataCache(), cols, chunk=256)
    kw = dict(stream_window_rows=256, max_iter=2, global_batch_size=512, tol=0.0)
    coef, opt = _port(cache, d, **kw)
    assert not opt.onehot_premat_active
    scatter, _ = _port(cache, d, sparse_kernel="scatter", **kw)
    np.testing.assert_array_equal(coef, scatter)  # the scatter fallback trained


def test_streamed_premat_auto_budgets_two_windows(monkeypatch):
    cols = _sparse_data(512, 2000, 6, seed=9)
    cache = _fill(HostDataCache(), cols)
    plan = streamed_onehot_plan(cache, 512, 1, 32, 128, 2000)
    from flink_ml_tpu_torch.linalg.onehot_sparse import premat_bytes

    n_units = 1  # one minibatch of one sub-batch a window
    two = 2 * (premat_bytes(n_units, plan.n_flat, plan.row_hi) + 7 * n_units * plan.n_flat)
    for limit, want in ((int(two / SGD._ONEHOT_PREMAT_HBM_FRACTION) + 1, True),
                        (int(two / SGD._ONEHOT_PREMAT_HBM_FRACTION) - 1, False)):
        monkeypatch.setattr(om, "_hbm_bytes_limit", lambda device=None, v=limit: v)
        assert SGD(device="cpu")._premat_streamed(plan, 1, 1, torch.device("cpu")) is want


def test_forced_streamed_onehot_infeasible_raises():
    cache = _fill(HostDataCache(), _sparse_data(256, 500, 4, seed=9))
    with pytest.raises(ValueError, match="f32"):  # the split-bf16 crossings carry f32, not f64
        SGD(device="cpu", stream_window_rows=16, sparse_kernel="onehot", dtype=torch.float64, **KW).optimize(
            np.zeros(500), cache, BinaryLogisticLoss.INSTANCE)
    dense = HostDataCache()
    dense.append({"features": np.zeros((8, 2), np.float32), "labels": np.zeros(8, np.float32)})
    dense.finish()
    with pytest.raises(ValueError, match="dense features"):
        _port(dense, 2, sparse_kernel="onehot", **KW)
