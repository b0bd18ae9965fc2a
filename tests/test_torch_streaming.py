"""The port's streamed fits against the JAX package on the CPU: training out
of a host-tier cache (``HostDataCache``, ``NativeDataCache``) through
``iteration/streaming.py``'s window loop — ``SGD.optimize``'s dense and
scatter paths, ``KMeans.fit_stream`` and ``MLPClassifier.fit_stream`` — on
one device and on ``train.mesh`` worlds of 2 and 4 gloo ranks
(``tests/torch_sharded_worker.py``), with checkpoints killed and resumed,
and streamed checkpoints crossing between the packages.

It mirrors the JAX package's ``tests/test_streaming.py``, the ``fit_stream``
tests of ``tests/test_kmeans.py:100/:125`` and
``tests/test_sharded_training.py:242``. The JAX side runs on a one-device
mesh (``MeshContext(n_data=1, n_model=1)``) for one-device fits, and at the
world's mesh under ``_jax_sharded`` (shard_map's ``check_vma`` off) for the
worlds. Both packages read the same numpy columns in the same cache chunks.

Tolerances, each with its source (``tests/test_torch_training.py``):
- coefficients and parameters against JAX: rtol 1e-4, atol 1e-6; loss
  histories rtol 1e-5 — float32 sums in another order;
- streamed against the port's resident fit on batch-aligned shards: bit for
  bit (the same rows and the same epoch function); on a ragged tail rtol
  1e-5 / atol 1e-6 (JAX ``test_streaming.py:107``: the short batch is masked
  padding instead of a clamped re-read);
- KMeans: assignments exact, centroids 1e-5; across ``train.mesh`` widths
  bit for bit;
- a resumed fit against its clean fit: bit for bit.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.checkpoint import CheckpointManager as JCheckpointManager
from flink_ml_tpu.checkpoint import ShardedCheckpointManager as JShardedCheckpointManager
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.iteration import HostDataCache as JHostDataCache
from flink_ml_tpu.iteration.streaming import WindowSchedule as JWindowSchedule
from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifier as JMLPClassifier
from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops import LeastSquareLoss as JLeastSquareLoss
from flink_ml_tpu.parallel.mesh import MeshContext as JMeshContext, mesh_context

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.checkpoint import CheckpointManager, ShardedCheckpointManager
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.iteration import HostDataCache
from flink_ml_tpu_torch.iteration.streaming import WindowSchedule, is_host_cache, plan_windows, run_windows
from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.native.cache import NativeDataCache
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
from flink_ml_tpu_torch.ops.optimizer import SGD

from tests.test_torch_sharded_training import _jax_sharded
from tests.torch_sharded_worker import run_world

torch.set_num_threads(1)

RTOL, ATOL, LOSS_RTOL = 1e-4, 1e-6, 1e-5
RAGGED_RTOL = 1e-5
CENTROID_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for opt in (Options.TRAIN_MESH, Options.TRAIN_MESH_MODEL, Options.TRAIN_STREAM_WINDOW_ROWS):
        config.unset(opt)
    for opt in (JOptions.TRAIN_MESH, JOptions.TRAIN_MESH_MODEL, JOptions.TRAIN_STREAM_WINDOW_ROWS):
        jconfig.unset(opt)


def _make_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    return X, (X @ rng.standard_normal(d) > 0).astype(np.float32)


def _fill(cache, cols, chunk=17):
    n = len(cols["labels"] if "labels" in cols else cols["features"])
    for a in range(0, n, chunk):
        cache.append({k: v[a:a + chunk] for k, v in cols.items()})
    cache.finish()
    return cache


def _caches(cols, tmp_path, budget=400, chunk=17, kind="host"):
    """The port's cache (``kind``: host or native) and the JAX package's
    ``HostDataCache`` of the same chunks, both spilling past ``budget``."""
    port = HostDataCache if kind == "host" else NativeDataCache
    return (_fill(port(memory_budget_bytes=budget, spill_dir=str(tmp_path / "port")), cols, chunk),
            _fill(JHostDataCache(memory_budget_bytes=budget, spill_dir=str(tmp_path / "jax")), cols, chunk))


def _jax_streamed(cache, dim, loss=None, **kw):
    with mesh_context(JMeshContext(n_data=1, n_model=1)):
        opt = JSGD(**kw)
        coef = opt.optimize(np.zeros(dim, np.float32), cache, loss or JBinaryLogisticLoss.INSTANCE)
    return coef, opt.loss_history


def _port(cache, dim, loss=None, **kw):
    opt = SGD(device="cpu", **kw)
    return opt.optimize(np.zeros(dim, np.float32), cache, loss or BinaryLogisticLoss.INSTANCE), opt


# --- the window schedule --------------------------------------------------------


@pytest.mark.parametrize("rows, batch, window, iters, check_loss, flops", [
    (10, 2, 4, 13, False, 0.0), (65_536, 64, 65_536, 5, False, 0.0), (64, 16, 4, 11, False, 0.0),
    (7, 3, 3, 9, True, 0.0), (50, 16, 20, 12, False, 1e14), (100, 7, 1000, 40, True, 0.0),
])
def test_window_schedule_equals_jax(rows, batch, window, iters, check_loss, flops):
    got = WindowSchedule(rows, batch, window, iters, check_loss=check_loss, flops_per_epoch=flops)
    want = JWindowSchedule(rows, batch, window, iters, check_loss=check_loss, flops_per_epoch=flops)
    assert (got.window, got.n_windows, got.chunk_len) == (want.window, want.n_windows, want.chunk_len)
    assert len(got.runs) == len(want.runs)
    for (j, s), (jj, ss) in zip(got.runs, want.runs):
        assert j == jj
        np.testing.assert_array_equal(s, ss)
        for a, b in zip(got.padded(s), want.padded(ss)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chunk_len_capped_by_max_iter():
    sched = WindowSchedule(local_rows=65_536, local_batch=64, window_rows=65_536, max_iter=5)
    assert sched.chunk_len == 5 and [len(s) for _, s in sched.runs] == [5]


def test_window_schedule_covers_all_epochs():
    sched = WindowSchedule(local_rows=10, local_batch=2, window_rows=4, max_iter=13)
    assert sched.window == 4 and sched.chunk_len == 2
    assert sum(len(s) for _, s in sched.runs) == 13
    assert [j for j, _ in sched.runs][:5] == [0, 1, 2, 0, 1]  # offsets 0, 2, 4, 6, 8 each pass
    for _j, starts in sched.runs:
        assert len(starts) <= sched.chunk_len and all(0 <= s <= sched.window - 2 for s in starts)


def test_run_windows_keeps_two_windows_and_observes_after_the_next_load():
    """``run_windows``'s order of events: window j's run is dispatched, the next
    window is loaded, then j's run is observed; a window the next run
    revisits is not reloaded."""
    log = []

    class Stream:
        def load(self, j):
            log.append(("load", j))
            return {"j": torch.tensor(j)}

    sched = WindowSchedule(local_rows=10, local_batch=2, window_rows=4, max_iter=13)

    def dispatch(i, win, starts, active, n_active):
        log.append(("run", int(win["j"])))
        return lambda: log.append(("observe", i)) and False

    loads = run_windows(Stream(), sched, dispatch)
    want, live = [("load", sched.runs[0][0])], {sched.runs[0][0]}
    for i, (j, _starts) in enumerate(sched.runs):
        want.append(("run", j))
        nxt = sched.runs[i + 1][0] if i + 1 < len(sched.runs) else None
        if nxt is not None and nxt not in live:
            want.append(("load", nxt))
            live.add(nxt)
        if nxt != j:
            live.discard(j)
        assert len(live) <= 2
        want.append(("observe", i))
    assert log == want and len(loads) == sum(1 for e in want if e[0] == "load")


def test_is_host_cache():
    assert is_host_cache(HostDataCache()) and is_host_cache(JHostDataCache())
    assert not is_host_cache({"labels": np.zeros(3)}) and not is_host_cache(object())


def test_windows_hold_the_shards_rows_and_mask(tmp_path):
    cols = {"features": np.arange(52 * 2, dtype=np.float32).reshape(52, 2),
            "labels": np.arange(52, dtype=np.float32)}
    cache = _fill(HostDataCache(300, str(tmp_path)), cols)
    stream, sched = plan_windows(cache, {"features": "features", "labels": "labels", "weights": "weights"},
                                 None, 8, 3, 30, device="cpu")
    assert stream.window == 9 and sched.window == 9  # rounded to whole batches
    last = stream.load(5)  # rows 45..51 then padding
    np.testing.assert_array_equal(last["labels"][:7].numpy(), np.arange(45, 52))
    np.testing.assert_array_equal(last["__mask__"].numpy(), [1] * 7 + [0] * 2)
    np.testing.assert_array_equal(last["weights"].numpy(), [1] * 7 + [0] * 2)
    # each load's parts are timed: the cache's rows, the host fill, the upload
    assert len(stream.parts) == 1 and sorted(stream.parts[0]) == ["fill_s", "rows_s", "upload_s"]
    assert all(v >= 0.0 for v in stream.parts[0].values())


# --- SGD: dense and scatter ------------------------------------------------------------


def test_misnamed_required_column_raises():
    X, y = _make_data(32, 3)
    cache = HostDataCache()
    cache.append({"features": X, "label": y})
    cache.finish()
    with pytest.raises(KeyError, match="labels"):
        _port(cache, 3, stream_window_rows=8, max_iter=2, tol=0.0)


@pytest.mark.parametrize("kind", ["host", "native"])
def test_streamed_sgd_matches_resident_aligned(tmp_path, kind):
    X, y = _make_data(64, 5, seed=1)
    kw = dict(max_iter=11, global_batch_size=16, tol=0.0, learning_rate=0.3)
    cache, jcache = _caches({"features": X, "labels": y}, tmp_path, kind=kind)
    assert (cache.spilled_chunks if kind == "native" else sum("files" in e for e in cache._log)) > 0
    got, opt = _port(cache, 5, stream_window_rows=4, **kw)
    want, _ = _port({"features": X, "labels": y}, 5, **kw)
    np.testing.assert_array_equal(got, want)  # the same rows, the same epoch function
    jgot, jloss = _jax_streamed(jcache, 5, stream_window_rows=4, **kw)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt.loss_history, jloss, rtol=LOSS_RTOL)
    assert opt.stream_stats["runs"] == 11 and len(opt.stream_stats["load_s"]) == 11


def test_streamed_sgd_matches_resident_ragged(tmp_path):
    X, y = _make_data(52, 4, seed=2)
    w = np.random.default_rng(3).uniform(0.5, 2.0, 52).astype(np.float32)
    kw = dict(max_iter=9, global_batch_size=24, tol=0.0, learning_rate=0.2)
    cache, jcache = _caches({"features": X, "labels": y, "weights": w}, tmp_path, budget=300)
    got, opt = _port(cache, 4, stream_window_rows=3, **kw)
    want, _ = _port({"features": X, "labels": y, "weights": w}, 4, **kw)
    np.testing.assert_allclose(got, want, rtol=RAGGED_RTOL, atol=ATOL)
    jgot, jloss = _jax_streamed(jcache, 4, stream_window_rows=3, **kw)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt.loss_history, jloss, rtol=LOSS_RTOL)


def test_streamed_sgd_tol_early_stop():
    X, y = _make_data(64, 5, seed=4)
    kw = dict(max_iter=500, global_batch_size=64, tol=0.4, learning_rate=0.5)
    want, resident = _port({"features": X, "labels": y}, 5, **kw)
    cols = {"features": X, "labels": y}
    got, streamed = _port(_fill(HostDataCache(), cols), 5, stream_window_rows=8, **kw)
    assert len(streamed.loss_history) < 500, "tol should stop early"
    assert len(streamed.loss_history) == len(resident.loss_history)
    np.testing.assert_allclose(streamed.loss_history, resident.loss_history, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=RAGGED_RTOL, atol=ATOL)
    jgot, jloss = _jax_streamed(_fill(JHostDataCache(), cols), 5, stream_window_rows=8, **kw)
    assert len(jloss) == len(streamed.loss_history)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)


def test_streamed_scatter_and_least_squares_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    n, d, K = 90, 300, 5
    cols = {"indices": rng.integers(0, d, size=(n, K)).astype(np.int32),
            "values": rng.normal(size=(n, K)).astype(np.float32),
            "labels": rng.normal(size=n).astype(np.float32)}
    kw = dict(max_iter=14, global_batch_size=20, tol=0.0, learning_rate=0.1, reg=0.01, elastic_net=0.5)
    cache, jcache = _caches(cols, tmp_path, budget=900)
    got, opt = _port(cache, d, LeastSquareLoss.INSTANCE, stream_window_rows=40, **kw)
    jgot, jloss = _jax_streamed(jcache, d, JLeastSquareLoss.INSTANCE, stream_window_rows=40, **kw)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(opt.loss_history, jloss, rtol=LOSS_RTOL)


def test_sparse_streamed_scatter_matches_resident(tmp_path):
    rng = np.random.default_rng(2)
    cols = {"indices": rng.integers(0, 512, size=(128, 8)).astype(np.int32),
            "values": rng.normal(size=(128, 8)).astype(np.float32),
            "labels": (rng.random(128) > 0.5).astype(np.float32)}
    kw = dict(max_iter=13, global_batch_size=32, tol=0.0, learning_rate=0.3, sparse_kernel="scatter")
    want, _ = _port(dict(cols), 512, **kw)
    cache, _ = _caches(cols, tmp_path, budget=2000)
    got, _ = _port(cache, 512, stream_window_rows=48, **kw)
    np.testing.assert_array_equal(got, want)  # aligned: the resident rows, the same epoch function


@pytest.mark.parametrize("sparse", [False, True])
def test_streamed_sgd_checkpoint_resume(tmp_path, sparse):
    rng = np.random.default_rng(6)
    X, y = _make_data(64, 5, seed=6)
    cols = ({"indices": rng.integers(0, 50, size=(64, 3)).astype(np.int32),
             "values": rng.normal(size=(64, 3)).astype(np.float32), "labels": y}
            if sparse else {"features": X, "labels": y})
    dim = 50 if sparse else 5
    kw = dict(max_iter=12, global_batch_size=16, tol=0.0, learning_rate=0.3, stream_window_rows=4,
              sparse_kernel="scatter")
    cache = _fill(HostDataCache(), cols)
    want, clean = _port(cache, dim, **kw)
    ckdir = str(tmp_path / "ck")
    got, _ = _port(cache, dim, checkpoint_manager=CheckpointManager(ckdir), checkpoint_interval=2, **kw)
    np.testing.assert_array_equal(got, want)
    steps = CheckpointManager(ckdir).all_steps()
    assert len(steps) >= 2, "expected several checkpoints"
    shutil.rmtree(f"{ckdir}/ckpt-{steps[-1]}")  # killed after the second-to-last snapshot
    resumed, opt = _port(cache, dim, checkpoint_manager=CheckpointManager(ckdir), checkpoint_interval=2, **kw)
    np.testing.assert_array_equal(resumed, want)
    # the snapshot carries every epoch's loss before it: the resumed history is whole
    assert opt.loss_history == clean.loss_history and len(clean.loss_history) == kw["max_iter"]
    state = CheckpointManager(ckdir).restore(CheckpointManager(ckdir).all_steps()[-1])
    assert sorted(state) == ["coef", "done", "loss_history", "next_run"]
    assert np.asarray(state["coef"]).shape == (dim,)


def test_listeners_are_refused():
    class Listener:
        pass

    X, y = _make_data(32, 3)
    with pytest.raises(ValueError, match="listener"):
        _port(_fill(HostDataCache(), {"features": X, "labels": y}), 3, stream_window_rows=4,
              listeners=[Listener()], max_iter=2, tol=0.0)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_streamed_checkpoint_resumes_in_the_other_package(tmp_path, writer):
    """Both packages' streamed fits snapshot the same state under the same
    fingerprint: a run killed in one resumes in the other and lands within
    the cross-package tolerance of both clean fits."""
    X, y = _make_data(64, 5, seed=7)
    cols = {"features": X, "labels": y}
    kw = dict(max_iter=12, global_batch_size=16, tol=0.0, learning_rate=0.3, stream_window_rows=4)
    ckdir = str(tmp_path / "ck")
    jcache, cache = _fill(JHostDataCache(), cols), _fill(HostDataCache(), cols)
    jclean, _ = _jax_streamed(jcache, 5, **kw)
    clean, _ = _port(cache, 5, **kw)
    if writer == "jax":
        _jax_streamed(jcache, 5, checkpoint_manager=JShardedCheckpointManager(ckdir), checkpoint_interval=2, **kw)
    else:
        _port(cache, 5, checkpoint_manager=ShardedCheckpointManager(ckdir), checkpoint_interval=2, **kw)
    steps = ShardedCheckpointManager(ckdir).all_steps()
    shutil.rmtree(f"{ckdir}/ckpt-{steps[-1]}")
    if writer == "jax":
        resumed, opt = _port(cache, 5, checkpoint_manager=ShardedCheckpointManager(ckdir), checkpoint_interval=2,
                             **kw)
    else:
        resumed, _ = _jax_streamed(jcache, 5, checkpoint_manager=JShardedCheckpointManager(ckdir),
                                   checkpoint_interval=2, **kw)
    np.testing.assert_allclose(resumed, clean, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(resumed, jclean, rtol=RTOL, atol=ATOL)


# --- MLPClassifier.fit_stream ---------------------------------------------------------


def _mlp_est(cls):
    return cls().set_hidden_layers(8).set_max_iter(10).set_global_batch_size(16).set_tol(0.0).set_seed(11)


def test_mlp_fit_stream_rejects_unknown_labels():
    X, _ = _make_data(32, 4, seed=8)
    y = np.asarray([0.0, 1.0, 2.0, 1.0] * 8, np.float32)
    cache = _fill(HostDataCache(), {"features": X, "labels": y})
    with pytest.raises(ValueError, match="not in classes"):
        _mlp_est(MLPClassifier).fit_stream(cache, classes=[0.0, 1.0], window_rows=4, device="cpu")


def test_mlp_fit_stream_matches_fit_and_jax(tmp_path):
    rng = np.random.default_rng(7)
    n, d = 64, 6
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.float64)
    est = _mlp_est(MLPClassifier)
    want = est.fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    resident_losses = list(est.loss_history)
    cache, jcache = _caches({"features": X, "labels": y.astype(np.float32)}, tmp_path, budget=500)
    got = est.fit_stream(cache, window_rows=4, device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    for (W1, b1), (W2, b2) in zip(got.params, want.params):  # batch-aligned: the resident rows
        np.testing.assert_array_equal(W1, W2)
        np.testing.assert_array_equal(b1, b2)
    assert est.loss_history == resident_losses
    with mesh_context(JMeshContext(n_data=1, n_model=1)):
        jgot = _mlp_est(JMLPClassifier).fit_stream(jcache, window_rows=4)
    for (W1, b1), (W2, b2) in zip(got.params, jgot.params):
        np.testing.assert_allclose(W1, np.asarray(W2), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b1, np.asarray(b2), rtol=RTOL, atol=ATOL)


def test_mlp_fit_stream_tol_stops_like_fit():
    rng = np.random.default_rng(9)
    X = rng.standard_normal((48, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    est = MLPClassifier().set_hidden_layers(4).set_max_iter(200).set_global_batch_size(16).set_tol(0.3).set_seed(2)
    want = est.fit(DataFrame.from_dict({"features": X, "label": y}), device="cpu")
    hist = list(est.loss_history)
    got = est.fit_stream(_fill(HostDataCache(), {"features": X, "labels": y.astype(np.float32)}), window_rows=16,
                         device="cpu")
    assert len(hist) < 200 and est.loss_history == hist
    for (W1, _), (W2, _) in zip(got.params, want.params):
        np.testing.assert_array_equal(W1, W2)


# --- KMeans.fit_stream ----------------------------------------------------------------


def _blob_rows(seed=7):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal([0, 0], 0.4, (60, 2)), rng.normal([6, 6], 0.4, (60, 2))])
    rng.shuffle(X)
    return X.astype(np.float32)


def test_kmeans_fit_stream_matches_fit_and_jax(tmp_path):
    X = _blob_rows()
    cache, jcache = _caches({"features": X}, tmp_path, budget=500)
    got = KMeans().set_k(2).set_seed(3).set_max_iter(15).fit_stream(cache, chunk_rows=16, device="cpu")
    want = KMeans().set_k(2).set_seed(3).set_max_iter(15).fit(DataFrame.from_dict({"features": X}), device="cpu")
    with mesh_context(JMeshContext(n_data=1, n_model=1)):
        jgot = JKMeans().set_k(2).set_seed(3).set_max_iter(15).fit_stream(jcache, chunk_rows=16)
        jpred = np.asarray(jgot.transform(JDataFrame.from_dict({"features": X}))["prediction"])
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_allclose(got.centroids, np.asarray(jgot.centroids), rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(got.weights, np.asarray(jgot.weights))
    pred = got.transform(DataFrame.from_dict({"features": X}), device="cpu")["prediction"]
    np.testing.assert_array_equal(np.asarray(pred), jpred)  # every assignment
    assert len(set(np.asarray(pred))) == 2


def test_kmeans_fit_stream_rejects_too_few_points():
    cache = HostDataCache()
    cache.append({"features": np.zeros((1, 2), np.float32)})
    cache.finish()
    with pytest.raises(ValueError, match="at least k"):
        KMeans().set_k(2).fit_stream(cache, device="cpu")


def test_kmeans_fit_stream_killed_and_resumed(tmp_path):
    """A snapshot every 3 epochs: resumed after the newest is deleted, and
    resumed at the terminal epoch (the counts recomputed by one pass), each
    equal to the clean fit; the fingerprint equals JAX's."""
    X = _blob_rows(8)
    cache = _fill(HostDataCache(), {"features": X})
    est = KMeans().set_k(2).set_seed(1).set_max_iter(9)
    clean = est.fit_stream(cache, chunk_rows=32, device="cpu")
    ckdir = str(tmp_path / "ck")
    first = est.fit_stream(cache, chunk_rows=32, checkpoint_manager=CheckpointManager(ckdir),
                           checkpoint_interval=3, device="cpu")
    terminal = est.fit_stream(cache, chunk_rows=32, checkpoint_manager=CheckpointManager(ckdir),
                              checkpoint_interval=3, device="cpu")
    steps = CheckpointManager(ckdir).all_steps()
    assert steps == [6, 9]
    shutil.rmtree(f"{ckdir}/ckpt-9")
    mgr = CheckpointManager(ckdir)
    resumed = est.fit_stream(cache, chunk_rows=32, checkpoint_manager=mgr, checkpoint_interval=3, device="cpu")
    for m in (first, terminal, resumed):
        np.testing.assert_array_equal(m.centroids, clean.centroids)
        np.testing.assert_array_equal(m.weights, clean.weights)
    jmgr = JCheckpointManager(str(tmp_path / "j"))
    with mesh_context(JMeshContext(n_data=1, n_model=1)):
        JKMeans().set_k(2).set_seed(1).set_max_iter(9).fit_stream(
            _fill(JHostDataCache(), {"features": X}), chunk_rows=32, checkpoint_manager=jmgr, checkpoint_interval=3)
    assert mgr.fingerprint == jmgr.fingerprint


# --- train.mesh worlds ------------------------------------------------------------------

DENSE = dict(max_iter=12, global_batch_size=32, tol=0.0, learning_rate=0.3)
SPARSE_DIM = 2000
SPARSE = dict(max_iter=12, global_batch_size=128, tol=0.0, learning_rate=0.3)
KMEANS = dict(k=3, seed=2, iters=7, chunk_rows=48)
MLP = dict(hidden=8, iters=6, batch=32, seed=1, window_rows=16)
TP_CKPT = dict(max_iter=8, global_batch_size=32, tol=0.0, learning_rate=0.3, stream_window_rows=8)
#: world -> train.mesh × train.mesh.model (the world's size is their product)
WORLDS = {2: (2, 1), 4: (2, 2), "4x1": (4, 1)}
#: the worlds on the data axis alone, and their widths
DATA_WORLDS = {2: 2, "4x1": 4}


def _dense_rows():
    return _make_data(96, 5, seed=9)


def _sparse_rows(n=512, d=SPARSE_DIM, K=6, seed=10):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.15] = 0.0
    return {"indices": rng.integers(0, d, size=(n, K)).astype(np.int32), "values": val,
            "labels": (rng.random(n) > 0.5).astype(np.float32)}


def _tp_rows():
    rng = np.random.default_rng(3)
    n, d, nnz = 96, 102, 6  # d not a multiple of n_model
    return {"indices": np.stack([rng.choice(d, nnz, replace=False) for _ in range(n)]).astype(np.int32),
            "values": rng.standard_normal((n, nnz)).astype(np.float32),
            "labels": (rng.random(n) > 0.5).astype(np.float32)}


def _kmeans_points():
    rng = np.random.default_rng(8)
    return np.concatenate([rng.normal(c, 0.5, (61, 2)) for c in (-3.0, 0.0, 3.0)]).astype(np.float32)


def _scenarios(world, tmp):
    X, y = _dense_rows()
    out = [("kmeans", "kmeans_streamed", dict(points=_kmeans_points(), **KMEANS))]
    if world in DATA_WORLDS:  # train.mesh 2 or 4: the data axis
        out += [
            ("dense", "sgd_streamed", dict(data={"features": X, "labels": y}, dim=5, stream_window_rows=8,
                                           **DENSE)),
            ("scatter", "sgd_streamed", dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32,
                                             sparse_kernel="scatter", **SPARSE)),
            ("premat", "sgd_streamed", dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32,
                                            sparse_kernel="onehot", onehot_premat="on", **SPARSE)),
            ("build", "sgd_streamed", dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32,
                                           sparse_kernel="onehot", onehot_premat="off", **SPARSE)),
            ("mlp", "mlp_streamed", dict(features=X, labels=y, **MLP)),
        ]
    if world == 2:
        out += [
            # the model axis on an explicit 1 x 2 mesh
            ("scatter_1x2", "sgd_streamed", dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32,
                                                 sparse_kernel="scatter", mesh=(1, 2, 1), **SPARSE)),
            ("onehot_1x2", "sgd_streamed", dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32,
                                                sparse_kernel="onehot", mesh=(1, 2, 1), **SPARSE)),
            ("dense_1x2", "sgd_streamed", dict(data={"features": X, "labels": y}, dim=5, stream_window_rows=8,
                                               mesh=(1, 2, 1), **DENSE)),
            ("tp_ckpt", "sgd_streamed_killed_and_resumed",
             dict(data=_tp_rows(), dim=102, ckpt_dir=os.path.join(tmp, "tp"), mesh=(1, 2, 1),
                  other_mesh=(2, 1, 1), sparse_kernel="onehot", **TP_CKPT)),
        ]
    if world == 4:  # train.mesh 2 x 2, and explicit 2 x 2 and two-slice meshes
        out += [(f"{k}_{'x'.join(map(str, mesh))}", "sgd_streamed",
                 dict(data=_sparse_rows(), dim=SPARSE_DIM, stream_window_rows=32, sparse_kernel=k, mesh=mesh,
                      **SPARSE))
                for mesh in ((2, 2, 1), (2, 1, 2)) for k in ("onehot", "scatter")]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: {scenario: [each rank's arrays]}}, each world spawned once."""
    tmp = str(tmp_path_factory.mktemp("streamed"))
    return {w: run_world(n_data * n_model, _scenarios(w, tmp), tmp, mesh=(n_data, n_model), tag=f"streamed{w}")
            for w, (n_data, n_model) in WORLDS.items()}


def _jax_mesh_fit(data, dim, mesh, **kw):
    n_data, n_model, n_slices = mesh
    ctx = JMeshContext(devices=jax.devices()[:n_data * n_model * n_slices], n_data=n_data, n_model=n_model,
                       n_slices=n_slices)
    with _jax_sharded():
        opt = JSGD(ctx=ctx, **kw)
        coef = opt.optimize(np.zeros(dim, np.float32), _fill(JHostDataCache(), data, chunk=40),
                            JBinaryLogisticLoss.INSTANCE)
    return coef, opt.loss_history


@pytest.mark.parametrize("world", [2, 4, "4x1"])
def test_every_rank_returns_the_same_model(worlds, world):
    for name, ranks in worlds[world].items():
        assert len(ranks) == WORLDS[world][0] * WORLDS[world][1], name
        for r in ranks[1:]:
            for key in ranks[0]:
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=f"{name}.{key}")


@pytest.mark.parametrize("world", list(DATA_WORLDS))
@pytest.mark.parametrize("name, kernel", [("dense", None), ("scatter", "scatter"), ("premat", "onehot"),
                                          ("build", "onehot")])
def test_streamed_sgd_on_the_data_axis_matches_jax(worlds, name, kernel, world):
    got = worlds[world][name][0]
    mesh = (DATA_WORLDS[world], 1, 1)
    if kernel is None:
        X, y = _dense_rows()
        want, jloss = _jax_mesh_fit({"features": X, "labels": y}, 5, mesh, stream_window_rows=8, **DENSE)
    else:
        want, jloss = _jax_mesh_fit(_sparse_rows(), SPARSE_DIM, mesh, stream_window_rows=32,
                                    sparse_kernel=kernel, **SPARSE)
    np.testing.assert_allclose(got["coef"], want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["losses"], jloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", list(DATA_WORLDS))
def test_streamed_premat_equals_build_on_a_world(worlds, world):
    assert bool(worlds[world]["premat"][0]["premat"]) and not bool(worlds[world]["build"][0]["premat"])
    np.testing.assert_array_equal(worlds[world]["premat"][0]["coef"], worlds[world]["build"][0]["coef"])


@pytest.mark.parametrize("name, mesh, kernel", [("scatter_1x2", (1, 2, 1), "scatter"),
                                                ("onehot_1x2", (1, 2, 1), "onehot"),
                                                ("onehot_2x2x1", (2, 2, 1), "onehot"),
                                                ("scatter_2x2x1", (2, 2, 1), "scatter"),
                                                ("onehot_2x1x2", (2, 1, 2), "onehot"),
                                                ("scatter_2x1x2", (2, 1, 2), "scatter")])
def test_streamed_sparse_on_the_model_axis_matches_jax(worlds, name, mesh, kernel):
    got = worlds[2 if mesh == (1, 2, 1) else 4][name][0]["coef"]
    want, _ = _jax_mesh_fit(_sparse_rows(), SPARSE_DIM, mesh, stream_window_rows=32, sparse_kernel=kernel,
                            **SPARSE)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if mesh == (1, 2, 1):  # one data shard: the one-device schedule, the margin summed in two pieces
        one, _ = _port(_fill(HostDataCache(), _sparse_rows(), chunk=40), SPARSE_DIM, stream_window_rows=32,
                       sparse_kernel=kernel, **SPARSE)
        # JAX's n_model invariance bound for the one-hot path (tests/test_onehot_sparse.py:543)
        rtol, atol = (2e-3, 1e-4) if kernel == "onehot" else (RAGGED_RTOL, ATOL)
        np.testing.assert_allclose(got, one, rtol=rtol, atol=atol)


def test_streamed_dense_on_a_model_axis_keeps_the_whole_coefficient(worlds):
    X, y = _dense_rows()
    want, _ = _jax_mesh_fit({"features": X, "labels": y}, 5, (1, 2, 1), stream_window_rows=8, **DENSE)
    got = worlds[2]["dense_1x2"][0]["coef"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # one data shard: the one-device streamed fit, bit for bit
    one, _ = _port(_fill(HostDataCache(), {"features": X, "labels": y}, chunk=40), 5, stream_window_rows=8,
                   **DENSE)
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("mesh", ["2x2x1", "2x1x2"])
def test_streamed_onehot_matches_streamed_scatter_on_a_mesh(worlds, mesh):
    np.testing.assert_allclose(worlds[4][f"onehot_{mesh}"][0]["coef"], worlds[4][f"scatter_{mesh}"][0]["coef"],
                               rtol=1e-3, atol=1e-5)


def test_tp_streamed_checkpoint_keeps_the_logical_dim_and_resumes(worlds):
    got = worlds[2]["tp_ckpt"][0]
    assert got["clean"].shape == (102,)
    assert tuple(got["saved_shape"]) == (102,), "the checkpoint holds the unpadded coefficient"
    np.testing.assert_array_equal(got["full"], got["clean"])
    np.testing.assert_array_equal(got["resumed"], got["clean"])
    assert int(got["refused"]) == 1  # another mesh shape is another job


def test_kmeans_fit_stream_is_bit_identical_across_train_mesh_widths(worlds):
    config.set(Options.TRAIN_MESH, 1)
    one = KMeans().set_k(KMEANS["k"]).set_seed(KMEANS["seed"]).set_max_iter(KMEANS["iters"]).fit_stream(
        _fill(HostDataCache(), {"features": _kmeans_points()}, chunk=61), chunk_rows=KMEANS["chunk_rows"],
        device="cpu")
    for world in DATA_WORLDS:  # widths 2 and 4
        got = worlds[world]["kmeans"][0]
        np.testing.assert_array_equal(got["centroids"], one.centroids)
        np.testing.assert_array_equal(got["weights"], one.weights)
        assert int(got["fits"]) == 1  # the deterministic tier
    # train.mesh.model 2 drops the deterministic tier: every rank fits the
    # whole stream on its own device, as one device does
    config.unset(Options.TRAIN_MESH)
    alone = KMeans().set_k(KMEANS["k"]).set_seed(KMEANS["seed"]).set_max_iter(KMEANS["iters"]).fit_stream(
        _fill(HostDataCache(), {"features": _kmeans_points()}, chunk=61), chunk_rows=KMEANS["chunk_rows"],
        device="cpu")
    np.testing.assert_array_equal(worlds[4]["kmeans"][0]["centroids"], alone.centroids)
    np.testing.assert_array_equal(worlds[4]["kmeans"][0]["weights"], alone.weights)
    assert int(worlds[4]["kmeans"][0]["fits"]) == 0
    jconfig.set(JOptions.TRAIN_MESH, 2)
    with _jax_sharded():
        jm = JKMeans().set_k(KMEANS["k"]).set_seed(KMEANS["seed"]).set_max_iter(KMEANS["iters"]).fit_stream(
            _fill(JHostDataCache(), {"features": _kmeans_points()}, chunk=61), chunk_rows=KMEANS["chunk_rows"])
    np.testing.assert_allclose(one.centroids, np.asarray(jm.centroids), rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(one.weights, np.asarray(jm.weights))


@pytest.mark.parametrize("world", list(DATA_WORLDS))
def test_mlp_fit_stream_on_the_data_axis_matches_jax(worlds, world):
    X, y = _dense_rows()
    jconfig.set(JOptions.TRAIN_MESH, DATA_WORLDS[world])
    with _jax_sharded():
        jm = (JMLPClassifier().set_hidden_layers(MLP["hidden"]).set_max_iter(MLP["iters"])
              .set_global_batch_size(MLP["batch"]).set_seed(MLP["seed"]).set_tol(0.0)
              .fit_stream(_fill(JHostDataCache(), {"features": X, "labels": y}, chunk=40),
                          window_rows=MLP["window_rows"]))
    got = worlds[world]["mlp"][0]
    for i, (W, b) in enumerate(jm.params):
        np.testing.assert_allclose(got[f"W{i}"], np.asarray(W), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[f"b{i}"], np.asarray(b), rtol=RTOL, atol=ATOL)
