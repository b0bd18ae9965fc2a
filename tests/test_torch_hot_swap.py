"""Publishing and hot-swapping model versions in the port against the JAX
package on the CPU (the JAX tests in ``tests/test_serving.py``'s
``TestHotSwap``, ``TestPollerScanBackoff`` and ``TestConcurrentSoak``):
the registry, ``publish_servable``, ``ModelVersionPoller`` (fallback past a
corrupt version, the ``failed`` map, the seeded backoff), the server's
``attach_poller`` under concurrent traffic, the batcher's ``draining`` and
``closed``, and ``set_model_data`` on npz streams.

Every comparison is exact: versions, failure maps and backoff waits are
host values, and a response is held bit for bit against its version's
per-stage transform at the response's bucket shape (the same operations
on the same padded rows).
"""
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.metrics import MLMetrics as JMLMetrics, metrics as jmetrics
from flink_ml_tpu.servable.api import ModelDataConflictError as JModelDataConflictError
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.serving import (
    ModelRegistry as JModelRegistry,
    ModelVersionPoller as JModelVersionPoller,
)

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.classification.logistic_regression import LogisticRegressionModel
from flink_ml_tpu_torch.servable import (
    LogisticRegressionModelServable,
    ModelDataConflictError,
    PipelineModelServable,
    StandardScalerModelServable,
    load_servable,
)
from flink_ml_tpu_torch.serving import (
    InferenceServer,
    ModelRegistry,
    ModelVersionPoller,
    ServingClosedError,
    ServingConfig,
    publish_servable,
)
from flink_ml_tpu_torch.serving.batcher import pad_to

torch.set_num_threads(1)

DIM = 5


@pytest.fixture(autouse=True)
def _unset_config():
    yield
    config.unset(Options.SERVING_POLL_INTERVAL_MS)
    config.unset(Options.SERVING_POLL_BACKOFF_MAX_MS)


def _model(seed):
    model = LogisticRegressionModel()
    model.coefficient = np.random.default_rng(seed).normal(size=DIM).astype(np.float32)
    return model


class _CorruptSave:
    """A stage whose saved model data is truncated: published through the
    real atomic path, so the poller sees a complete but unloadable version."""

    def __init__(self, model):
        self.model = model

    def save(self, path):
        self.model.save(path)
        npz = os.path.join(path, "data", "model_data.npz")
        blob = open(npz, "rb").read()
        with open(npz, "wb") as f:
            f.write(blob[: len(blob) // 2])


def _row(X, i):
    return DataFrame.from_dict({"features": X[i:i + 1]})


# ---------------------------------------------------------------------------
# registry and publishing
# ---------------------------------------------------------------------------


def test_registry_requires_monotonic_versions():
    for registry in (ModelRegistry("ml.serving[th-mono]"), JModelRegistry("ml.serving[th-mono]")):
        registry.swap(3, object())
        with pytest.raises(ValueError, match="advance"):
            registry.swap(3, object())
        with pytest.raises(ValueError, match="advance"):
            registry.swap(2, object())


def test_publish_numbers_versions_and_refuses_overwrite(tmp_path):
    import flink_ml_tpu.servable.api as japi

    d = str(tmp_path / "pub")
    p1 = publish_servable(_model(1), d)
    p2 = publish_servable(_model(2), d, precision="f32")
    assert (os.path.basename(p1), os.path.basename(p2)) == ("v-1", "v-2")
    with pytest.raises(FileExistsError):
        publish_servable(_model(1), d, version=2)
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    for path, seed in ((p1, 1), (p2, 2)):  # both packages load a published version
        np.testing.assert_array_equal(load_servable(path).coefficient, _model(seed).coefficient)
        np.testing.assert_array_equal(japi.load_servable(path).coefficient, _model(seed).coefficient)
    for precision in ("bf16", "int8"):
        with pytest.raises(NotImplementedError, match="A 10"):
            publish_servable(_model(1), d, precision=precision)
    with pytest.raises(ValueError, match="unknown publish precision"):
        publish_servable(_model(1), d, precision="fp8")


# ---------------------------------------------------------------------------
# the poller
# ---------------------------------------------------------------------------


def _poll_sequence(Poller, Registry, d, name):
    registry = Registry(f"ml.serving[{name}]")
    poller = Poller(d, registry, interval_ms=10)
    got = [poller.poll_once(), registry.version, sorted(poller.failed)]
    publish_servable(_model(4), d, version=4)
    got += [poller.poll_once(), registry.version, poller.poll_once(), sorted(poller.failed)]
    return got, poller, registry


def test_poller_skips_corrupt_and_falls_back_to_newest_intact(tmp_path):
    results = {}
    for pkg, Poller, Registry, m in (("port", ModelVersionPoller, ModelRegistry, metrics),
                                     ("jax", JModelVersionPoller, JModelRegistry, jmetrics)):
        d = str(tmp_path / pkg)
        publish_servable(_model(1), d)  # v-1, intact
        os.makedirs(os.path.join(d, "v-2"))  # v-2: marker present, metadata unreadable
        with open(os.path.join(d, "v-2", "metadata"), "w") as f:
            f.write("{not json")
        publish_servable(_CorruptSave(_model(3)), d, version=3)  # v-3: model data truncated
        os.makedirs(os.path.join(d, "v-5.tmp"))  # noise the scan ignores
        os.makedirs(os.path.join(d, "v-9.corrupt"))
        got, poller, registry = _poll_sequence(Poller, Registry, d, f"th-fallback-{pkg}")
        failures = m.get(registry.scope, (MLMetrics if pkg == "port" else JMLMetrics).SERVING_SWAP_FAILURES)
        results[pkg] = got + [failures, {v: type(e).__name__ for v, e in poller.failed.items()}]
    assert results["port"][:8] == results["jax"][:8] == [1, 1, [2, 3], 4, 4, None, [2, 3], 2]
    assert set(results["port"][8]) == {2, 3}


def test_failed_map_is_lock_guarded_and_skips_known_bad(tmp_path):
    registry = ModelRegistry("ml.serving[th-failedmap]")
    loads = []
    poller = ModelVersionPoller(str(tmp_path), registry, loader=lambda p: loads.append(p) or object(),
                                interval_ms=5.0)
    err = RuntimeError("bad version")
    poller._record_failed(7, err)
    assert poller.known_failed(7) and not poller.known_failed(8) and poller.failed[7] is err
    publish_servable(_model(1), str(tmp_path), version=7)
    assert poller.poll_once() is None and loads == []  # a known-bad version is never reloaded


def test_backoff_sequence_equals_the_jax_pollers_under_the_same_seed(tmp_path):
    def waits(Poller, Registry):
        poller = Poller(str(tmp_path), Registry("ml.serving[th-backoff]"), interval_ms=10,
                        backoff_max_ms=35, backoff_seed=3)
        seq = [poller.backoff_state()]
        for _ in range(6):
            poller._note_scan_error()
            seq.append(poller.backoff_state())
        poller._note_scan_ok()
        return seq + [poller.backoff_state()]

    got, want = waits(ModelVersionPoller, ModelRegistry), waits(JModelVersionPoller, JModelRegistry)
    assert got == want
    assert got[-2]["next_wait_s"] == pytest.approx(0.035) and got[-1]["backing_off"] is False
    config.set(Options.SERVING_POLL_INTERVAL_MS, 250.0)
    config.set(Options.SERVING_POLL_BACKOFF_MAX_MS, 900.0)
    poller = ModelVersionPoller(str(tmp_path), ModelRegistry("ml.serving[th-config]"))
    assert (poller.interval_s, poller.backoff_max_s) == (0.25, 0.9)


def test_loop_backs_off_on_scan_errors_and_recovers(tmp_path):
    registry = ModelRegistry("ml.serving[th-backoff-loop]")
    poller = ModelVersionPoller(str(tmp_path), registry, interval_ms=1)
    healthy = poller.poll_once

    def broken():
        raise OSError("publish dir unreadable")

    poller.poll_once = broken
    errors_before = metrics.get(registry.scope, MLMetrics.SERVING_POLL_ERRORS, 0)
    poller.start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            poller.start()
        deadline = time.monotonic() + 5.0
        while poller.backoff_state()["consecutive_errors"] < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert poller.backoff_state()["consecutive_errors"] >= 3
        assert metrics.get(registry.scope, MLMetrics.SERVING_POLL_ERRORS, 0) > errors_before
        poller.poll_once = healthy
        deadline = time.monotonic() + 5.0
        while poller.backoff_state()["backing_off"] and time.monotonic() < deadline:
            time.sleep(0.005)
        assert poller.backoff_state()["backing_off"] is False
    finally:
        poller.stop()
    assert poller._thread is None


# ---------------------------------------------------------------------------
# the server: attach_poller, draining, closed
# ---------------------------------------------------------------------------


def test_attach_poller_hot_swaps_under_concurrent_traffic(tmp_path):
    n_threads, per_thread = 4, 20
    X = np.random.default_rng(11).normal(size=(64, DIM))
    d = str(tmp_path / "models")
    publish_servable(_model(1), d)
    cfg = ServingConfig(max_batch_size=16, max_delay_ms=2, queue_capacity_rows=4096, default_timeout_ms=60_000)
    server = InferenceServer(name="th-soak", serving_config=cfg, warmup_template=_row(X, 0), device="cpu")
    poller = server.attach_poller(d, interval_ms=5, start=False)
    with pytest.raises(RuntimeError, match="already attached"):
        server.attach_poller(d, start=False)
    assert poller.poll_once() == 1
    servables = {1: load_servable(os.path.join(d, "v-1"))}
    responses, errors = {}, []
    started = threading.Barrier(n_threads + 1)

    def client(tid):
        try:
            started.wait()
            for i in range(per_thread):
                j = (tid * 37 + i * 13) % X.shape[0]
                responses[(tid, i)] = (j, server.submit(_row(X, j)).result())
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    started.wait()
    deadline = time.perf_counter() + 30.0
    while len(responses) < n_threads and time.perf_counter() < deadline:
        time.sleep(0.001)
    publish_servable(_model(2), d)
    publish_servable(_CorruptSave(_model(9)), d)  # v-3: unloadable, skipped
    assert poller.poll_once() == 2
    assert set(poller.failed) == {3}
    servables[2] = load_servable(os.path.join(d, "v-2"))
    for k in range(4):  # strictly after the flip: all v2
        j = (k * 29) % X.shape[0]
        responses[("post", k)] = (j, server.predict(_row(X, j)))
        assert responses[("post", k)][1].model_version == 2
    for t in threads:
        t.join()
    server.close()
    assert not errors, errors
    assert len(responses) == n_threads * per_thread + 4
    assert {r.model_version for _, r in responses.values()} <= {1, 2}
    for tid in range(n_threads):
        seen = [responses[(tid, i)][1].model_version for i in range(per_thread)]
        assert seen == sorted(seen)
    for j, resp in responses.values():
        ref = servables[resp.model_version].transform(pad_to(_row(X, j), resp.bucket), device="cpu")
        for col in ("prediction", "rawPrediction"):
            np.testing.assert_array_equal(resp.dataframe.column(col), ref.column(col)[:1])
    assert metrics.get(server.scope, MLMetrics.VERSION) == 2
    assert metrics.get(server.scope, MLMetrics.SERVING_SWAPS) == 2
    assert metrics.get(server.scope, MLMetrics.SERVING_SWAP_FAILURES) == 1


def test_the_attached_poller_thread_swaps_and_close_stops_it(tmp_path):
    X = np.random.default_rng(12).normal(size=(4, DIM))
    d = str(tmp_path / "models")
    publish_servable(_model(1), d)
    swapped = []
    with InferenceServer(name="th-thread", device="cpu", warmup_template=_row(X, 0),
                         serving_config=ServingConfig(max_batch_size=4, max_delay_ms=0.5)) as server:
        poller = server.attach_poller(d, interval_ms=5)
        poller.on_swap = lambda version, servable: swapped.append(version)
        deadline = time.monotonic() + 10.0
        while server.model_version != 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert server.predict(_row(X, 1)).model_version == 1
        publish_servable(_model(2), d)
        while server.model_version != 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert server.predict(_row(X, 1)).model_version == 2
    assert poller._thread is None and swapped[-1] == 2


def test_draining_and_closed_follow_close():
    server = InferenceServer(name="th-drain", device="cpu")
    batcher = server._batcher
    assert (batcher.draining, batcher.closed) == (False, False)
    server.close()
    assert (batcher.draining, batcher.closed) == (True, True)
    with pytest.raises(ServingClosedError):
        server.submit(DataFrame.from_dict({"features": np.ones((1, DIM))}))
    with pytest.raises(ServingClosedError, match="shut down"):
        batcher.submit(DataFrame.from_dict({"features": np.ones((1, DIM))}), 1.0)


# ---------------------------------------------------------------------------
# set_model_data on npz streams
# ---------------------------------------------------------------------------


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    buf.seek(0)
    return buf


def test_set_model_data_equals_the_jax_package_on_the_same_streams():
    rng = np.random.default_rng(5)
    coef, mean, std = rng.normal(size=DIM), rng.normal(size=DIM), rng.random(DIM) + 0.5
    lr = LogisticRegressionModelServable().set_model_data(_npz(coefficient=coef))
    jlr = jlib.LogisticRegressionModelServable().set_model_data(_npz(coefficient=coef))
    np.testing.assert_array_equal(lr.coefficient, jlr.coefficient)
    # two streams merged by name
    sc = StandardScalerModelServable().set_model_data(_npz(mean=mean), _npz(std=std))
    jsc = jlib.StandardScalerModelServable().set_model_data(_npz(mean=mean), _npz(std=std))
    np.testing.assert_array_equal(sc.mean, jsc.mean)
    np.testing.assert_array_equal(sc.std, jsc.std)
    with pytest.raises(ValueError, match="at least 1"):
        LogisticRegressionModelServable().set_model_data()
    conflicts = []
    for Servable, Error in ((StandardScalerModelServable, ModelDataConflictError),
                            (jlib.StandardScalerModelServable, JModelDataConflictError)):
        with pytest.raises(Error) as e:
            Servable().set_model_data(_npz(mean=mean, std=std), _npz(std=std))
        conflicts.append((e.value.key, e.value.stream_index, str(e.value)))
    assert conflicts[0] == conflicts[1] == (conflicts[0][0], 1, conflicts[0][2])
    # a pipeline hands one stream to each stage that holds model data
    X = rng.normal(size=(7, DIM))
    pipe = PipelineModelServable([
        StandardScalerModelServable().set_input_col("features").set_output_col("scaled"),
        LogisticRegressionModelServable().set_features_col("scaled"),
    ]).set_model_data(_npz(mean=mean, std=std), _npz(coefficient=coef))
    jpipe = JPipeline([
        jlib.StandardScalerModelServable().set_input_col("features").set_output_col("scaled"),
        jlib.LogisticRegressionModelServable().set_features_col("scaled"),
    ]).set_model_data(_npz(mean=mean, std=std), _npz(coefficient=coef))
    np.testing.assert_array_equal(pipe.servables[1].coefficient, jpipe.servables[1].coefficient)
    out = pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    assert np.asarray(out.column("rawPrediction")).shape == (7, 2)
