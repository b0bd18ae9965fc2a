"""The port's online training against the JAX package on the CPU: window
descriptors and streams (``ops/windows.py``, ``iteration/stream.py``), the
unbounded loop (``iteration/iteration.py`` ``iterate_unbounded``), the
snapshot driver and the online models (``models/online.py``),
OnlineLogisticRegression (FTRL), OnlineKMeans and OnlineStandardScaler.

The first part twins each test function of the JAX package's
``tests/test_online.py`` outside ``TestBatchStandardScaler`` (34) on the
port, with ``device="cpu"``. The rest feeds the same seeded numpy batches
through both packages (the JAX side under ``JAX_PLATFORMS=cpu``).

Tolerances, each with its reason:
- FTRL coefficients and OnlineKMeans centroids and weights, every version:
  rtol 1e-5 / atol 1e-6 — float32 products summed in another order. The
  FTRL zero pattern equal, with the float64 run keeping every
  ``| |z| − l1 |`` above 1e-4, so no threshold flip can hide in the
  tolerance; assignments equal wherever the float64 top-two distance gap
  passes 1e-4;
- OnlineStandardScaler: statistics bit-equal (both packages sum in float64
  with the same ``_mean_std``), gated outputs, versions and pending rows
  equal;
- windows: JSON byte-equal, batches equal.
"""
import json
import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.checkpoint import CheckpointManager as JCheckpointManager
from flink_ml_tpu.checkpoint import ShardedCheckpointManager as JShardedCheckpointManager
from flink_ml_tpu.iteration import iteration as jiteration
from flink_ml_tpu.iteration import stream as jstream
from flink_ml_tpu.linalg.vectors import DenseVector as JDenseVector
from flink_ml_tpu.models import STAGE_REGISTRY as JSTAGE_REGISTRY
from flink_ml_tpu.models import online as jonline
from flink_ml_tpu.models.classification.online_logistic_regression import (
    OnlineLogisticRegression as JOnlineLogisticRegression,
)
from flink_ml_tpu.models.clustering.online_kmeans import OnlineKMeans as JOnlineKMeans
from flink_ml_tpu.models.feature.standard_scaler import OnlineStandardScaler as JOnlineStandardScaler
from flink_ml_tpu.ops import windows as jwindows
from flink_ml_tpu.serving.registry import publish_servable as jpublish_servable
from flink_ml_tpu.utils import read_write as jrw

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.checkpoint import CheckpointManager, ShardedCheckpointManager
from flink_ml_tpu_torch.iteration import iteration as piteration
from flink_ml_tpu_torch.iteration import stream as pstream
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models import STAGE_REGISTRY, get_stage_class
from flink_ml_tpu_torch.models.classification.online_logistic_regression import (
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
from flink_ml_tpu_torch.models.clustering.online_kmeans import OnlineKMeans, OnlineKMeansModel
from flink_ml_tpu_torch.models.feature.standard_scaler import (
    TIMESTAMP_COL,
    OnlineStandardScaler,
    OnlineStandardScalerModel,
    StandardScaler,
)
from flink_ml_tpu_torch.models.online import QueueBatchStream
from flink_ml_tpu_torch.ops import windows as pwindows
from flink_ml_tpu_torch.ops.windows import (
    CountTumblingWindows,
    EventTimeTumblingWindows,
    ProcessingTimeTumblingWindows,
)
from flink_ml_tpu_torch.servable import LogisticRegressionModelServable, load_servable
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig, publish_servable
from flink_ml_tpu_torch.utils import read_write as rw

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
L1_MARGIN = 1e-4  # the float64 FTRL run's least | |z| - l1 | over every version and dimension
ASSIGN_MARGIN = 1e-4  # float64 top-two distance gap past which assignments must agree

RNG = np.random.default_rng(33)
CPU = "cpu"


# --- the twins of the JAX package's tests/test_online.py ----------------------


def _lr_batch(n=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X @ np.linspace(1, -1, d) > 0).astype(np.float64)
    return {"features": X.astype(np.float64), "label": y}


def _init_lr_model_data(d=4):
    return DataFrame(["coefficient"], None, [[DenseVector(np.zeros(d))]])


class TestOnlineLogisticRegression:
    def test_param_defaults(self):
        olr = OnlineLogisticRegression()
        assert olr.get_alpha() == 0.1
        assert olr.get_beta() == 0.1
        assert olr.get_batch_strategy() == "count"
        assert olr.get_global_batch_size() == 32

    def test_stepwise_training_versions_and_gauges(self):
        stream = QueueBatchStream()
        olr = OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).set_global_batch_size(64)
        model = olr.fit(stream, device=CPU)
        assert model.model_version == 0

        stream.add(_lr_batch(seed=1))
        assert model.advance() == 1
        assert model.model_version == 1
        assert not np.allclose(model.coefficient, 0.0)

        stream.add(_lr_batch(seed=2))
        stream.add(_lr_batch(seed=3))
        assert model.advance() == 2
        assert model.model_version == 3
        scope = model._metric_scope()
        assert metrics.get(scope, MLMetrics.VERSION) == 3
        assert metrics.get(scope, MLMetrics.TIMESTAMP) is not None

    def test_converges_with_batches(self):
        stream = QueueBatchStream()
        model = (OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).set_alpha(0.5)
                 .fit(stream, device=CPU))
        for i in range(30):
            stream.add(_lr_batch(n=128, seed=i))
        model.advance()
        test = _lr_batch(n=256, seed=99)
        out = model.transform(DataFrame.from_dict(test), device=CPU)
        acc = (out["prediction"] == test["label"]).mean()
        assert acc > 0.9, acc
        assert (out["version"] == model.model_version).all()

    def test_bounded_input_trains_eagerly(self):
        df = DataFrame.from_dict(_lr_batch(n=256, seed=7))
        model = (OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data())
                 .set_global_batch_size(64).fit(df, device=CPU))
        assert model.model_version == 4

    def test_empty_batch_is_not_end_of_stream(self):
        stream = QueueBatchStream()
        model = OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).fit(stream, device=CPU)
        stream.add(DataFrame.from_dict({"features": np.zeros((0, 4)), "label": np.zeros(0)}))
        stream.add(_lr_batch(seed=1))
        assert model.advance() == 1
        assert model.model_version == 1

    def test_advance_on_snapshot_hook_fires_per_version(self, tmp_path):
        stream = QueueBatchStream()
        model = OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).fit(stream, device=CPU)
        seen = []

        def hook(version, payload):
            assert model.model_version == version
            seen.append((version, np.asarray(payload).copy()))

        stream.add(_lr_batch(seed=1))
        stream.add(_lr_batch(seed=2))
        assert model.advance(on_snapshot=hook) == 2
        assert [v for v, _ in seen] == [1, 2]
        np.testing.assert_array_equal(seen[-1][1], model.coefficient)

        stream.add(_lr_batch(seed=3))

        def boom(version, payload):
            raise RuntimeError("publisher crashed")

        with pytest.raises(RuntimeError, match="publisher crashed"):
            model.advance(on_snapshot=boom)
        assert model.model_version == 3
        stream.add(_lr_batch(seed=4))
        assert model.advance() == 1
        assert model.model_version == 4

    def test_save_load_preserves_model_version(self, tmp_path):
        stream = QueueBatchStream()
        model = OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).fit(stream, device=CPU)
        stream.add(_lr_batch(seed=1))
        stream.add(_lr_batch(seed=2))
        model.advance()
        path = str(tmp_path / "olr")
        model.save(path)
        loaded = OnlineLogisticRegressionModel.load(path)
        assert loaded.model_version == model.model_version == 2
        np.testing.assert_allclose(loaded.coefficient, model.coefficient)

    def test_ftrl_l1_produces_sparsity(self):
        stream = QueueBatchStream()
        model = (OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data())
                 .set_reg(1.0).set_elastic_net(1.0).fit(stream, device=CPU))
        stream.add(_lr_batch(seed=1))
        model.advance()
        assert np.count_nonzero(model.coefficient) < model.coefficient.size


class TestOnlineKMeans:
    def test_stepwise_updates_move_centroids(self):
        stream = QueueBatchStream()
        okm = OnlineKMeans().set_k(2).set_seed(1).set_decay_factor(0.5).set_random_initial_model_data(dim=2)
        model = okm.fit(stream, device=CPU)
        c0 = model.centroids.copy()
        pts = np.concatenate([RNG.normal([0, 0], 0.1, (32, 2)), RNG.normal([5, 5], 0.1, (32, 2))])
        stream.add({"features": pts})
        assert model.advance() == 1
        assert not np.allclose(model.centroids, c0)
        assert model.weights.sum() > 0
        for seed in range(8):
            rng = np.random.default_rng(seed)
            stream.add({"features": np.concatenate([rng.normal([0, 0], 0.1, (32, 2)),
                                                    rng.normal([5, 5], 0.1, (32, 2))])})
        model.advance()
        got = model.centroids[np.argsort(model.centroids[:, 0])]
        np.testing.assert_allclose(got, [[0, 0], [5, 5]], atol=0.5)

    def test_transform_uses_latest_version(self):
        stream = QueueBatchStream()
        model = OnlineKMeans().set_k(2).set_seed(3).set_random_initial_model_data(dim=2).fit(stream, device=CPU)
        pts = np.concatenate([RNG.normal([0, 0], 0.1, (16, 2)), RNG.normal([5, 5], 0.1, (16, 2))])
        stream.add({"features": pts})
        model.advance()
        pred = model.transform(DataFrame.from_dict({"features": pts}), device=CPU)["prediction"]
        assert len(set(pred[:16])) == 1 and len(set(pred[16:])) == 1

    def test_requires_initial_model(self):
        with pytest.raises(RuntimeError, match="initial model"):
            OnlineKMeans().fit(QueueBatchStream(), device=CPU)


class TestOnlineStandardScaler:
    def test_versions_per_window_and_cumulative_stats(self):
        df = DataFrame.from_dict({"input": np.arange(12.0)[:, None]})
        model = OnlineStandardScaler().set_windows(CountTumblingWindows.of(4)).fit(df)
        assert model.version_history == [0, 1, 2]
        assert model.model_version == 2
        batch_model = StandardScaler().set_input_col("input").fit(
            DataFrame.from_dict({"input": np.arange(12.0)[:, None]}), device=CPU)
        np.testing.assert_allclose(model.mean, batch_model.mean, atol=1e-6)
        np.testing.assert_allclose(model.std, batch_model.std, atol=1e-6)

    def test_stepwise_feed_each_batch_is_window(self):
        stream = QueueBatchStream()
        model = OnlineStandardScaler().fit(stream)
        stream.add({"input": np.asarray([[1.0], [3.0]])})
        assert model.advance() == 1
        assert model.model_version == 0
        np.testing.assert_allclose(model.mean, [2.0])
        stream.add({"input": np.asarray([[5.0], [7.0]])})
        model.advance()
        assert model.model_version == 1
        np.testing.assert_allclose(model.mean, [4.0])

    def test_transform_appends_version_column(self):
        df = DataFrame.from_dict({"input": RNG.normal(size=(8, 3))})
        model = OnlineStandardScaler().fit(df)
        out = model.transform(df, device=CPU)
        assert (out["version"] == model.model_version).all()
        np.testing.assert_allclose(out["output"].std(axis=0, ddof=1), 1.0, atol=1e-4)


class TestModelDelayGating:
    def _fit_event_time(self, delay_ms):
        ts = np.asarray([10.0, 50.0, 110.0, 150.0, 210.0, 250.0])
        df = DataFrame.from_dict({"input": np.arange(6.0)[:, None], TIMESTAMP_COL: ts})
        stream = QueueBatchStream()
        stream.add(df)
        model = (OnlineStandardScaler().set_windows(EventTimeTumblingWindows.of(100))
                 .set_max_allowed_model_delay_ms(delay_ms).fit(stream))
        return model, stream

    def test_rows_join_earliest_fresh_enough_version(self):
        model, _ = self._fit_event_time(delay_ms=100)
        model.advance(1)
        assert model.model_version == 0 and model.model_timestamp == 50.0
        q = DataFrame.from_dict({"input": np.asarray([[1.0], [2.0], [3.0]]),
                                 TIMESTAMP_COL: np.asarray([100.0, 200.0, 260.0])})
        out = model.transform(q, device=CPU)
        assert len(out) == 3
        np.testing.assert_array_equal(out["version"], [0, 1, 2])
        np.testing.assert_array_equal([v[0] for v in out["input"]], [1.0, 2.0, 3.0])

    def test_too_new_rows_buffer_until_version_arrives(self):
        model, stream = self._fit_event_time(delay_ms=0)
        model.advance(1)
        model.advance()
        assert model.model_version == 2 and model.model_timestamp == 250.0
        q = DataFrame.from_dict({"input": np.asarray([[1.0], [2.0]]), TIMESTAMP_COL: np.asarray([240.0, 400.0])})
        out = model.transform(q, device=CPU)
        assert len(out) == 1
        np.testing.assert_array_equal(out["version"], [2])
        assert model.pending_rows == 1
        stream.add(DataFrame.from_dict({"input": np.asarray([[9.0], [9.5]]),
                                        TIMESTAMP_COL: np.asarray([410.0, 450.0])}))
        served = model.serve_pending(device=CPU)
        assert served is not None and len(served) == 1
        assert model.pending_rows == 0
        assert served["version"][0] == model.model_version

    def test_no_timestamp_column_serves_everything(self):
        model, _ = self._fit_event_time(delay_ms=0)
        model.advance(1)
        out = model.transform(DataFrame.from_dict({"input": np.asarray([[1.0], [2.0]])}), device=CPU)
        assert len(out) == 2

    def test_model_timestamp_survives_save_load(self, tmp_path):
        model, _ = self._fit_event_time(delay_ms=0)
        model.advance()
        model.save(str(tmp_path / "oss"))
        loaded = OnlineStandardScalerModel.load(str(tmp_path / "oss"))
        assert loaded.model_timestamp == 250.0
        assert loaded.model_version == 2
        q = DataFrame.from_dict({"input": np.asarray([[1.0]]), TIMESTAMP_COL: np.asarray([200.0])})
        out = loaded.transform(q, device=CPU)
        assert len(out) == 1 and loaded.pending_rows == 0

    def test_processing_time_windows_one_version_per_added_batch(self):
        stream = QueueBatchStream()
        model = OnlineStandardScaler().set_windows(ProcessingTimeTumblingWindows.of(1)).fit(stream)
        stream.add(DataFrame.from_dict({"input": np.arange(4.0)[:, None],
                                        TIMESTAMP_COL: np.asarray([0.0, 5000.0, 10000.0, 15000.0])}))
        assert model.advance() == 1

    def test_legacy_checkpoint_without_timestamp_loads_ungated(self, tmp_path):
        model, _ = self._fit_event_time(delay_ms=0)
        model.advance()
        path = str(tmp_path / "legacy")
        model.save(path)
        meta_path = os.path.join(path, "metadata")
        with open(meta_path) as f:
            meta = json.load(f)
        del meta["modelTimestamp"]
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        loaded = OnlineStandardScalerModel.load(path)
        assert loaded.model_timestamp == float("inf")
        q = DataFrame.from_dict({"input": np.asarray([[1.0]]), TIMESTAMP_COL: np.asarray([1e12])})
        assert len(loaded.transform(q, device=CPU)) == 1

    def test_pending_rows_survive_save_load(self, tmp_path):
        model, _ = self._fit_event_time(delay_ms=0)
        model.advance()
        model.transform(DataFrame.from_dict({"input": np.asarray([[7.0]]), TIMESTAMP_COL: np.asarray([400.0])}),
                        device=CPU)
        assert model.pending_rows == 1
        path = str(tmp_path / "with-pending")
        model.save(path)
        loaded = OnlineStandardScalerModel.load(path)
        assert loaded.pending_rows == 1
        np.testing.assert_array_equal(loaded._pending[0].column(TIMESTAMP_COL), [400.0])

    def test_pending_sparse_rows_survive_save_load(self, tmp_path):
        model, _ = self._fit_event_time(delay_ms=0)
        model.advance()
        q = DataFrame(["input", TIMESTAMP_COL], None, [[SparseVector(1, [0], [7.0])], np.asarray([400.0])])
        model.transform(q, device=CPU)
        assert model.pending_rows == 1
        path = str(tmp_path / "sparse-pending")
        model.save(path)
        loaded = OnlineStandardScalerModel.load(path)
        assert loaded.pending_rows == 1
        cell = loaded._pending[0].column("input")[0]
        assert isinstance(cell, SparseVector)
        np.testing.assert_array_equal(cell.to_array(), [7.0])


class TestOnlineModelPersistence:
    def test_online_kmeans_save_load(self, tmp_path):
        stream = QueueBatchStream()
        model = OnlineKMeans().set_k(2).set_seed(1).set_random_initial_model_data(dim=2).fit(stream, device=CPU)
        pts = np.concatenate([RNG.normal([0, 0], 0.1, (16, 2)), RNG.normal([5, 5], 0.1, (16, 2))])
        stream.add({"features": pts})
        model.advance()
        path = str(tmp_path / "okm")
        model.save(path)
        loaded = OnlineKMeansModel.load(path)
        assert loaded.model_version == model.model_version
        np.testing.assert_allclose(loaded.centroids, model.centroids)
        df = DataFrame.from_dict({"features": pts})
        np.testing.assert_array_equal(loaded.transform(df, device=CPU)["prediction"],
                                      model.transform(df, device=CPU)["prediction"])

    def test_online_lr_loaded_model_serves_identically(self, tmp_path):
        stream = QueueBatchStream()
        model = (OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data())
                 .set_global_batch_size(64).fit(stream, device=CPU))
        stream.add(_lr_batch(seed=2))
        model.advance()
        model.save(str(tmp_path / "olr"))
        loaded = OnlineLogisticRegressionModel.load(str(tmp_path / "olr"))
        df = DataFrame.from_dict({"features": _lr_batch(seed=3)["features"]})
        np.testing.assert_array_equal(loaded.transform(df, device=CPU)["prediction"],
                                      model.transform(df, device=CPU)["prediction"])

    def test_loaded_model_keeps_serving_without_stream(self, tmp_path):
        stream = QueueBatchStream()
        model = OnlineKMeans().set_k(2).set_seed(5).set_random_initial_model_data(dim=2).fit(stream, device=CPU)
        stream.add({"features": RNG.normal(size=(8, 2))})
        model.advance()
        model.save(str(tmp_path / "m"))
        loaded = OnlineKMeansModel.load(str(tmp_path / "m"))
        assert loaded.advance() == 0
        out = loaded.transform(DataFrame.from_dict({"features": RNG.normal(size=(4, 2))}), device=CPU)
        assert len(out) == 4


class TestOnlineKillResume:
    @staticmethod
    def _feed(batches, close=True):
        stream = QueueBatchStream()
        for b in batches:
            stream.add(b)
        if close:
            stream.close()
        return stream

    def _lr_est(self, mgr=None, interval=1):
        est = OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data()).set_global_batch_size(64)
        if mgr is not None:
            est.set_checkpoint(mgr, interval)
        return est

    def _lr_batches(self, n=8):
        return [_lr_batch(n=64, seed=100 + i) for i in range(n)]

    def test_online_lr_kill_resume_identity_and_version_continuity(self, tmp_path):
        batches = self._lr_batches(8)
        clean = self._lr_est().fit(self._feed(batches), device=CPU)
        clean.advance()
        assert clean.model_version == 8
        crashed = self._lr_est(CheckpointManager(str(tmp_path / "olr"))).fit(self._feed(batches[:5]), device=CPU)
        assert crashed.advance() == 5
        resumed = self._lr_est(CheckpointManager(str(tmp_path / "olr"))).fit(self._feed(batches), device=CPU)
        assert resumed.model_version == 5
        np.testing.assert_array_equal(resumed.coefficient, crashed.coefficient)
        resumed.advance()
        assert resumed.model_version == 8
        assert resumed.version_history == [6, 7, 8]
        np.testing.assert_array_equal(resumed.coefficient, clean.coefficient)

    def test_online_lr_resume_with_interval_recomputes_tail(self, tmp_path):
        batches = self._lr_batches(8)
        clean = self._lr_est().fit(self._feed(batches), device=CPU)
        clean.advance()
        crashed = self._lr_est(CheckpointManager(str(tmp_path / "olr2")), interval=2).fit(
            self._feed(batches[:5]), device=CPU)
        assert crashed.advance() == 5
        resumed = self._lr_est(CheckpointManager(str(tmp_path / "olr2")), interval=2).fit(
            self._feed(batches), device=CPU)
        assert resumed.model_version == 4
        resumed.advance()
        assert resumed.model_version == 8
        assert resumed.version_history == [5, 6, 7, 8]
        np.testing.assert_array_equal(resumed.coefficient, clean.coefficient)

    def test_online_lr_lazy_skip_survives_stream_dry(self, tmp_path):
        batches = self._lr_batches(6)
        crashed = self._lr_est(CheckpointManager(str(tmp_path / "olr3"))).fit(self._feed(batches[:5]), device=CPU)
        assert crashed.advance() == 5
        stream = self._feed(batches[:3], close=False)
        resumed = self._lr_est(CheckpointManager(str(tmp_path / "olr3"))).fit(stream, device=CPU)
        assert resumed.advance() == 0
        assert resumed.model_version == 5
        for b in batches[3:]:
            stream.add(b)
        assert resumed.advance() == 1
        assert resumed.model_version == 6
        assert resumed.version_history == [6]

    def test_online_lr_fingerprint_guard_refuses_other_config(self, tmp_path):
        crashed = self._lr_est(CheckpointManager(str(tmp_path / "fp"))).fit(
            self._feed(self._lr_batches(3)), device=CPU)
        crashed.advance()
        other = self._lr_est(CheckpointManager(str(tmp_path / "fp"))).set_alpha(0.9)
        with pytest.raises(ValueError, match="different\\s+run"):
            other.fit(self._feed(self._lr_batches(3)), device=CPU)

    def test_online_kmeans_kill_resume_identity(self, tmp_path):
        def kmeans_batches(n=8):
            out = []
            for i in range(n):
                rng = np.random.default_rng(200 + i)
                out.append({"features": np.concatenate([rng.normal([0, 0], 0.1, (16, 2)),
                                                        rng.normal([5, 5], 0.1, (16, 2))])})
            return out

        def est(mgr=None):
            e = OnlineKMeans().set_k(2).set_seed(7).set_decay_factor(0.7).set_random_initial_model_data(dim=2)
            if mgr is not None:
                e.set_checkpoint(mgr)
            return e

        batches = kmeans_batches(8)
        clean = est().fit(self._feed(batches), device=CPU)
        clean.advance()
        assert clean.model_version == 8
        crashed = est(CheckpointManager(str(tmp_path / "okm"))).fit(self._feed(batches[:5]), device=CPU)
        assert crashed.advance() == 5
        resumed = est(CheckpointManager(str(tmp_path / "okm"))).fit(self._feed(batches), device=CPU)
        assert resumed.model_version == 5
        np.testing.assert_array_equal(resumed.centroids, crashed.centroids)
        resumed.advance()
        assert resumed.model_version == 8
        assert resumed.version_history == [6, 7, 8]
        np.testing.assert_array_equal(resumed.centroids, clean.centroids)
        np.testing.assert_array_equal(resumed.weights, clean.weights)

    def test_online_standard_scaler_kill_resume_identity(self, tmp_path):
        rng = np.random.default_rng(42)
        batches = [{"input": rng.normal(3.0, 2.0, size=(16, 3))} for _ in range(8)]

        def est(mgr=None):
            e = OnlineStandardScaler()
            if mgr is not None:
                e.set_checkpoint(mgr)
            return e

        clean = est().fit(self._feed(batches))
        clean.advance()
        assert clean.model_version == 7
        crashed = est(CheckpointManager(str(tmp_path / "oss"))).fit(self._feed(batches[:5]))
        assert crashed.advance() == 5
        assert crashed.model_version == 4
        resumed = est(CheckpointManager(str(tmp_path / "oss"))).fit(self._feed(batches))
        assert resumed.model_version == 4
        np.testing.assert_array_equal(resumed.mean, crashed.mean)
        resumed.advance()
        assert resumed.model_version == 7
        assert resumed.version_history == [5, 6, 7]
        np.testing.assert_array_equal(resumed.mean, clean.mean)
        np.testing.assert_array_equal(resumed.std, clean.std)

    def test_online_scaler_event_time_windows_resume_at_window_granularity(self, tmp_path):
        ts = np.asarray([10.0, 110.0, 210.0, 310.0, 410.0, 510.0])
        cols = {"input": np.arange(6.0)[:, None], TIMESTAMP_COL: ts}

        def est(mgr=None):
            e = OnlineStandardScaler().set_windows(EventTimeTumblingWindows.of(100))
            if mgr is not None:
                e.set_checkpoint(mgr)
            return e

        clean = est().fit(self._feed([cols]))
        clean.advance()
        assert clean.model_version == 5
        crashed = est(CheckpointManager(str(tmp_path / "ossw"))).fit(self._feed([cols]))
        assert crashed.advance(3) == 3
        assert crashed.model_version == 2
        resumed = est(CheckpointManager(str(tmp_path / "ossw"))).fit(self._feed([cols]))
        assert resumed.model_version == 2
        resumed.advance()
        assert resumed.model_version == 5
        assert resumed.version_history == [3, 4, 5]
        np.testing.assert_array_equal(resumed.mean, clean.mean)
        np.testing.assert_array_equal(resumed.std, clean.std)

    def test_different_initial_model_refuses_resume(self, tmp_path):
        batches = self._lr_batches(3)
        self._lr_est(CheckpointManager(str(tmp_path / "init"))).fit(self._feed(batches), device=CPU).advance()
        other = (OnlineLogisticRegression()
                 .set_initial_model_data(DataFrame(["coefficient"], None, [[DenseVector(np.ones(4))]]))
                 .set_global_batch_size(64).set_checkpoint(CheckpointManager(str(tmp_path / "init"))))
        with pytest.raises(ValueError, match="different\\s+run"):
            other.fit(self._feed(batches), device=CPU)

    def test_replay_shorter_than_offset_raises(self, tmp_path):
        batches = self._lr_batches(5)
        crashed = self._lr_est(CheckpointManager(str(tmp_path / "short"))).fit(self._feed(batches), device=CPU)
        assert crashed.advance() == 5
        resumed = self._lr_est(CheckpointManager(str(tmp_path / "short"))).fit(self._feed(batches[:2]), device=CPU)
        with pytest.raises(ValueError, match="before the checkpointed offset"):
            resumed.advance()


# --- against the JAX package ---------------------------------------------------


def _jax_feed(batches, close=True):
    stream = jonline.QueueBatchStream()
    for b in batches:
        stream.add(b)
    if close:
        stream.close()
    return stream


def _port_feed(batches, close=True):
    stream = QueueBatchStream()
    for b in batches:
        stream.add(b)
    if close:
        stream.close()
    return stream


def _ftrl_batches(n_batches=8, rows=128, d=16, seed=5, weights=False, faint=False):
    """Seeded batches whose label depends on the first half of the features;
    with ``faint`` the last quarter of the columns is scaled by 1e-2, so an
    L1 term zeroes them."""
    rng = np.random.default_rng(seed)
    w_true = np.concatenate([rng.normal(size=d // 2), np.zeros(d - d // 2)])
    scale = np.where(np.arange(d) >= d - d // 4, 1e-2 if faint else 1.0, 1.0)
    out = []
    for _ in range(n_batches):
        X = rng.normal(size=(rows, d)) * scale
        batch = {"features": X, "label": (X @ w_true + 0.3 * rng.normal(size=rows) > 0).astype(np.float64)}
        if weights:
            batch["weight"] = rng.uniform(0.5, 2.0, size=rows)
        out.append(batch)
    return out


def _ftrl64(coef0, batches, alpha, beta, l1, l2):
    """Float64 FTRL of the same batches: each version's coefficient and the
    least | |z| - l1 | of its update."""
    coef = np.asarray(coef0, np.float64)
    n, z = np.zeros_like(coef), np.zeros_like(coef)
    coefs, margins = [], []
    for b in batches:
        X = np.asarray(b["features"], np.float32).astype(np.float64)
        y = np.asarray(b["label"], np.float32).astype(np.float64)
        w = np.asarray(b["weight"], np.float32).astype(np.float64) if "weight" in b else np.ones_like(y)
        p = 1.0 / (1.0 + np.exp(-(X @ coef)))
        grad = X.T @ (w * (p - y))
        g = grad / w.sum() if w.sum() != 0 else grad
        sigma = (np.sqrt(n + g * g) - np.sqrt(n)) / alpha
        z = z + g - sigma * coef
        n = n + g * g
        margins.append(float(np.min(np.abs(np.abs(z) - l1))))
        coef = np.where(np.abs(z) <= l1, 0.0, (np.sign(z) * l1 - z) / ((beta + np.sqrt(n)) / alpha + l2))
        coefs.append(coef)
    return coefs, margins


@pytest.mark.parametrize("reg,elastic_net,weights", [(0.0, 0.0, False), (0.01, 0.5, True)],
                         ids=["reg0", "reg0.01-en0.5-weighted"])
def test_ftrl_every_version_matches_jax_and_float64(reg, elastic_net, weights):
    d = 16
    batches = _ftrl_batches(d=d, weights=weights, faint=reg > 0)
    init = np.random.default_rng(9).normal(size=d) * 0.1

    def versions(est, stream, **kw):
        est = (est.set_initial_model_data(init_df(est)).set_alpha(0.5).set_beta(0.1).set_reg(reg)
               .set_elastic_net(elastic_net).set_global_batch_size(128))
        if weights:
            est.set_weight_col("weight")
        model = est.fit(stream, **kw)
        got = []
        model.advance(on_snapshot=lambda v, payload: got.append(np.asarray(payload, np.float64)))
        return got

    def init_df(est):
        if isinstance(est, JOnlineLogisticRegression):
            return JDataFrame(["coefficient"], None, [[JDenseVector(init)]])
        return DataFrame(["coefficient"], None, [[DenseVector(init)]])

    port = versions(OnlineLogisticRegression(), _port_feed(batches), device=CPU)
    jax_ = versions(JOnlineLogisticRegression(), _jax_feed(batches))
    l1, l2 = elastic_net * reg, (1.0 - elastic_net) * reg
    ref, margins = _ftrl64(np.asarray(init, np.float32), batches, 0.5, 0.1, l1, l2)
    assert len(port) == len(jax_) == len(ref) == 8
    assert min(margins) > L1_MARGIN, margins  # no dimension sits at the L1 threshold
    zeros = 0
    for v, (p, j, r) in enumerate(zip(port, jax_, ref), start=1):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL, err_msg=f"version {v}")
        np.testing.assert_array_equal(p == 0, j == 0, err_msg=f"version {v}: zero pattern")
        np.testing.assert_array_equal(p == 0, r == 0, err_msg=f"version {v}: zero pattern vs float64")
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-6, err_msg=f"version {v} vs float64")
        zeros += int(np.sum(p == 0))
    assert (zeros > 0) == (reg > 0)  # L1 zeroes part of the coefficient only when it is on


def test_ftrl_state_stays_float32():
    """n and z are float32, as JAX keeps them with x64 off: nothing is
    promoted to float64 along the step."""
    stream = _port_feed(_ftrl_batches(n_batches=2, d=8))
    model = (OnlineLogisticRegression().set_initial_model_data(DataFrame(["coefficient"], None,
                                                                         [[DenseVector(np.zeros(8))]]))
             .set_global_batch_size(128).fit(stream, device=CPU))
    model.advance()
    coef, n, z = model._snapshots.state
    assert coef.dtype == n.dtype == z.dtype == torch.float32
    assert model.coefficient.dtype == np.float32


def _kmeans_batches(n_batches=8, rows=64, d=8, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 3.0, size=(4, d))
    return [{"features": centers[rng.integers(0, 4, rows)] + rng.normal(0.0, 0.7, size=(rows, d))}
            for _ in range(n_batches)]


def _decided(X, centroids):
    """Rows whose float64 top-two distance gap to ``centroids`` passes the margin."""
    dist = np.sqrt(((X[:, None, :] - centroids[None].astype(np.float64)) ** 2).sum(-1))
    two = np.sort(dist, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) > ASSIGN_MARGIN


def test_online_kmeans_every_version_matches_jax():
    batches = _kmeans_batches()
    probe = np.random.default_rng(12).normal(0.0, 3.0, size=(128, 8))

    def run(est, feed, df_cls, **kw):
        model = est.set_k(4).set_seed(3).set_decay_factor(0.5).set_random_initial_model_data(dim=8).fit(
            feed(batches), **kw)
        got = []

        def hook(version, payload):
            pred = model.transform(df_cls.from_dict({"features": probe}), **kw)["prediction"]
            got.append((np.asarray(payload[0]), np.asarray(payload[1]), np.asarray(pred)))

        model.advance(on_snapshot=hook)
        return got

    port = run(OnlineKMeans(), _port_feed, DataFrame, device=CPU)
    jax_ = run(JOnlineKMeans(), _jax_feed, JDataFrame)
    assert len(port) == len(jax_) == 8
    for v, ((pc, pw, pp), (jc, jw, jp)) in enumerate(zip(port, jax_), start=1):
        np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL, err_msg=f"version {v} centroids")
        np.testing.assert_allclose(pw, jw, rtol=RTOL, atol=ATOL, err_msg=f"version {v} weights")
        decided = _decided(probe, pc)
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(pp[decided], jp[decided], err_msg=f"version {v} assignments")


def test_online_kmeans_blend_keeps_empty_clusters_and_decays_their_weight():
    """A cluster that gets no point keeps its centroid, and its weight decays."""
    init = DataFrame(["centroids", "weights"], None,
                     [[np.asarray([[0.0, 0.0], [100.0, 100.0]])], [np.asarray([4.0, 6.0])]])
    stream = _port_feed([{"features": np.asarray([[1.0, 1.0], [3.0, 3.0]])}])
    model = (OnlineKMeans().set_k(2).set_decay_factor(0.5).set_initial_model_data(init).fit(stream, device=CPU))
    model.advance()
    np.testing.assert_array_equal(model.centroids[1], [100.0, 100.0])
    np.testing.assert_allclose(model.weights, [4.0, 3.0])  # 4·0.5 + 2, 6·0.5
    np.testing.assert_allclose(model.centroids[0], [1.0, 1.0])  # λ = 2/4: halfway to the mean 2


def test_online_scaler_statistics_bit_equal_to_jax_every_version():
    rng = np.random.default_rng(21)
    batches = [{"input": rng.normal(5.0, 3.0, size=(rows, 8))} for rows in (16, 33, 7, 128, 1, 64, 256, 19)]
    got = {}
    for name, est, feed in (("port", OnlineStandardScaler(), _port_feed), ("jax", JOnlineStandardScaler(), _jax_feed)):
        model = est.fit(feed(batches))
        seen = []
        model.advance(on_snapshot=lambda v, payload: seen.append(
            (v, np.asarray(payload[0]).copy(), np.asarray(payload[1]).copy())))
        got[name] = seen
    assert [v for v, _, _ in got["port"]] == [v for v, _, _ in got["jax"]] == list(range(8))
    for (v, pm, ps), (_, jm, js) in zip(got["port"], got["jax"]):
        assert pm.dtype == jm.dtype == np.float64
        np.testing.assert_array_equal(pm, jm, err_msg=f"version {v} mean")
        np.testing.assert_array_equal(ps, js, err_msg=f"version {v} std")


@pytest.mark.parametrize("delay", [0, 50])
def test_online_scaler_gated_transform_matches_jax(delay):
    rng = np.random.default_rng(23)
    train = {"input": rng.normal(2.0, 1.5, size=(40, 3)), TIMESTAMP_COL: np.sort(rng.uniform(0, 400, 40))}
    queries = [
        {"input": rng.normal(size=(6, 3)), TIMESTAMP_COL: np.asarray([20.0, 130.0, 90.0, 260.0, 380.0, 1000.0])},
        {"input": rng.normal(size=(3, 3)), TIMESTAMP_COL: np.asarray([0.0, 450.0, 220.0])},
    ]
    later = {"input": rng.normal(size=(5, 3)), TIMESTAMP_COL: np.asarray([990.0, 1010.0, 1050.0, 1100.0, 1180.0])}
    outs = {}
    for name, est, feed, df_cls, kw in (
            ("port", OnlineStandardScaler(), QueueBatchStream, DataFrame, {"device": CPU}),
            ("jax", JOnlineStandardScaler(), jonline.QueueBatchStream, JDataFrame, {})):
        stream = feed()
        stream.add(df_cls.from_dict(train))
        windows = (EventTimeTumblingWindows if name == "port" else jwindows.EventTimeTumblingWindows).of(100)
        model = est.set_windows(windows).set_max_allowed_model_delay_ms(delay).set_with_mean(True).fit(stream)
        model.advance(1)
        got = [model.transform(df_cls.from_dict(q), **kw) for q in queries]
        pending = [model.pending_rows]
        stream.add(df_cls.from_dict(later))
        got.append(model.serve_pending(**kw))
        pending.append(model.pending_rows)
        outs[name] = (got, pending, model.version_history)
    (pgot, ppend, phist), (jgot, jpend, jhist) = outs["port"], outs["jax"]
    assert ppend == jpend and phist == jhist
    for p, j in zip(pgot, jgot):
        assert (p is None) == (j is None)
        if p is None:
            continue
        assert p.get_column_names() == j.get_column_names()
        np.testing.assert_array_equal(p["version"], j["version"])
        np.testing.assert_array_equal(p.scalars(TIMESTAMP_COL), j.scalars(TIMESTAMP_COL))
        np.testing.assert_array_equal(p.vectors("input"), j.vectors("input"))
        np.testing.assert_array_equal(p.vectors("output"), j.vectors("output"))


# --- windows, streams and the unbounded loop ------------------------------------

_DESCRIPTORS = [
    ("GlobalWindows", ()), ("CountTumblingWindows", (4,)), ("EventTimeTumblingWindows", (100,)),
    ("ProcessingTimeTumblingWindows", (7,)), ("EventTimeSessionWindows", (30,)),
    ("ProcessingTimeSessionWindows", (3,)),
]


@pytest.mark.parametrize("name,args", _DESCRIPTORS, ids=[n for n, _ in _DESCRIPTORS])
def test_window_descriptors_json_byte_equal_and_round_trip(name, args):
    p, j = getattr(pwindows, name)(*args), getattr(jwindows, name)(*args)
    assert json.dumps(p.to_json_dict()) == json.dumps(j.to_json_dict())
    assert pwindows.Windows.from_json_dict(j.to_json_dict()) == p
    assert jwindows.Windows.from_json_dict(p.to_json_dict()) == j
    port_est, jax_est = OnlineStandardScaler().set_windows(p), JOnlineStandardScaler().set_windows(j)
    assert json.dumps(port_est.param_map_to_json(), sort_keys=True) == \
        json.dumps(jax_est.param_map_to_json(), sort_keys=True)


def test_a_param_map_with_windows_loads_across_the_packages(tmp_path):
    OnlineStandardScaler().set_windows(EventTimeTumblingWindows.of(250)).set_max_allowed_model_delay_ms(9).save(
        str(tmp_path / "port"))
    loaded = JOnlineStandardScaler.load(str(tmp_path / "port"))
    assert loaded.get_windows() == jwindows.EventTimeTumblingWindows(250)
    assert loaded.get_max_allowed_model_delay_ms() == 9
    JOnlineStandardScaler().set_windows(jwindows.EventTimeSessionWindows.with_gap(40)).save(str(tmp_path / "jax"))
    back = OnlineStandardScaler.load(str(tmp_path / "jax"))
    assert type(back) is OnlineStandardScaler
    assert back.get_windows() == pwindows.EventTimeSessionWindows(40)
    assert type(rw.load_stage(str(tmp_path / "jax"))) is OnlineStandardScaler


def _stream_batches():
    rng = np.random.default_rng(31)
    out, t = [], 0.0
    for rows in (5, 0, 9, 3, 12, 1):
        gaps = rng.choice([1.0, 2.0, 45.0], size=rows)
        ts = t + np.cumsum(gaps)
        t = float(ts[-1]) if rows else t
        out.append({"x": rng.normal(size=(rows, 2)), "t": ts, "i": np.arange(rows)})
    return out


def _clock():
    ticks = iter(np.arange(0.0, 1000.0, 2.5))
    return lambda: float(next(ticks))


@pytest.mark.parametrize("name,args", _DESCRIPTORS, ids=[n for n, _ in _DESCRIPTORS])
def test_window_stream_gives_the_jax_batches(name, args):
    batches = _stream_batches()
    got = list(pstream.window_stream(iter(batches), getattr(pwindows, name)(*args), "t", now=_clock()))
    want = list(jstream.window_stream(iter(batches), getattr(jwindows, name)(*args), "t", now=_clock()))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_split_by_tumbling_window_and_batch_stream_from_dataframe_match_jax():
    batch = {"x": np.arange(10.0), "t": np.asarray([5.0, 99.0, 100.0, 350.0, 120.0, 0.0, 999.0, 101.0, 7.0, 300.0])}
    got = list(pstream.split_by_tumbling_window(batch, 100, batch["t"]))
    want = list(jstream.split_by_tumbling_window(batch, 100, batch["t"]))
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    cols = {"features": np.random.default_rng(2).normal(size=(23, 3)), "label": np.arange(23.0)}
    for size in (None, 5, 23, 50):
        p = list(pstream.batch_stream_from_dataframe(DataFrame.from_dict(cols), size))
        j = list(jstream.batch_stream_from_dataframe(JDataFrame.from_dict(cols), size))
        assert len(p) == len(j)
        for a, b in zip(p, j):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    empty = {"features": np.zeros((0, 3)), "label": np.zeros(0)}
    assert list(pstream.batch_stream_from_dataframe(DataFrame.from_dict(empty))) == []


def _unbounded(pkg, stream, mgr=None, stop_after=None):
    """A toy unbounded body on ``pkg`` (the port or JAX iteration module):
    the running sum of the batches, each epoch's ``(epoch, sum)`` an output
    and each listener call recorded (its own output on odd epochs)."""
    calls = []

    class Listener(pkg.IterationListener):
        def on_epoch_watermark_incremented(self, epoch, context):
            calls.append(("epoch", epoch))
            if epoch % 2:
                context.output(("listener", epoch))

        def on_iteration_terminated(self, context):
            calls.append(("terminated",))

    def body(variables, batch, epoch):
        total = np.asarray(variables[0]) + float(batch)
        return pkg.IterationBodyResult([total], outputs=[("out", epoch, float(total))])

    config = pkg.IterationConfig(checkpoint_interval=1, checkpoint_manager=mgr) if mgr else None
    outs = []
    for out in pkg.iterate_unbounded([np.asarray(0.0)], stream, body, config=config, listeners=[Listener()]):
        outs.append(out)
        if stop_after is not None and sum(o[0] == "out" for o in outs) == stop_after:
            break
    return outs, calls


def test_iterate_unbounded_matches_jax_and_resumes_across_the_packages(tmp_path):
    batches = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]
    port, jax_ = _unbounded(piteration, iter(batches)), _unbounded(jiteration, iter(batches))
    assert port == jax_
    assert port[1][-1] == ("terminated",)
    clean = port[0]
    for writer, reader in ((jiteration, piteration), (piteration, jiteration)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        writer_mgr = JShardedCheckpointManager(d) if writer is jiteration else ShardedCheckpointManager(d)
        first, _ = _unbounded(writer, iter(batches), writer_mgr, stop_after=4)
        reader_mgr = JShardedCheckpointManager(d) if reader is jiteration else ShardedCheckpointManager(d)
        rest, calls = _unbounded(reader, iter(batches), reader_mgr)  # a source replayed from the start
        assert [o for o in first + rest if o[0] == "out"] == [o for o in clean if o[0] == "out"]
        assert calls[0] == ("epoch", 4)  # no epoch run twice, none skipped
    for pkg, mgr_cls in ((piteration, CheckpointManager), (jiteration, JCheckpointManager)):
        d = str(tmp_path / f"short-{pkg.__name__.split('.')[0]}")
        _unbounded(pkg, iter(batches), mgr_cls(d), stop_after=5)
        with pytest.raises(ValueError, match="before the checkpointed offset"):
            _unbounded(pkg, iter(batches[:3]), mgr_cls(d))


class _FingerprintProbe:
    """A checkpoint manager that only records the fingerprint it is given."""

    fingerprint = None

    def set_fingerprint(self, fingerprint):
        self.fingerprint = fingerprint

    def restore_latest(self, **_kw):
        return None

    def save(self, step, state):
        pass


def _estimators(pkg):
    """The three online estimators of ``pkg`` ("port" or "jax") with one
    configuration, and a batch of each's input."""
    if pkg == "port":
        lr, km, sc, df, dv, win = (OnlineLogisticRegression, OnlineKMeans, OnlineStandardScaler, DataFrame,
                                   DenseVector, pwindows)
    else:
        lr, km, sc, df, dv, win = (JOnlineLogisticRegression, JOnlineKMeans, JOnlineStandardScaler, JDataFrame,
                                   JDenseVector, jwindows)
    init = np.linspace(-0.2, 0.3, 4)
    return {
        "lr": lr().set_initial_model_data(df(["coefficient"], None, [[dv(init)]])).set_alpha(0.4).set_reg(0.02)
        .set_elastic_net(0.3).set_global_batch_size(64),
        "kmeans": km().set_k(3).set_seed(4).set_decay_factor(0.25).set_random_initial_model_data(dim=4),
        "scaler": sc().set_windows(win.CountTumblingWindows.of(8)).set_with_mean(True),
    }


def test_online_fingerprints_equal_jax():
    for name in ("lr", "kmeans", "scaler"):
        probes = {}
        for pkg in ("port", "jax"):
            est = _estimators(pkg)[name]
            probes[pkg] = _FingerprintProbe()
            est.set_checkpoint(probes[pkg])
            feed = _port_feed if pkg == "port" else _jax_feed
            est.fit(feed([]), **({"device": CPU} if pkg == "port" and name != "scaler" else {}))
        assert probes["port"].fingerprint == probes["jax"].fingerprint is not None, name


@pytest.mark.parametrize("name", ["lr", "kmeans", "scaler"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_of_one_package_resumes_in_the_other(tmp_path, name, writer):
    rng = np.random.default_rng(41)
    if name == "lr":
        batches = [_lr_batch(n=64, seed=300 + i) for i in range(8)]
    elif name == "kmeans":
        batches = [{"features": rng.normal(size=(32, 4))} for _ in range(8)]
    else:
        batches = [{"input": rng.normal(1.0, 2.0, size=(8, 4))} for _ in range(8)]
    reader = "port" if writer == "jax" else "jax"

    def fit(pkg, stream_batches, mgr=None):
        est = _estimators(pkg)[name]
        if mgr is not None:
            est.set_checkpoint(mgr, 2)
        feed = _port_feed if pkg == "port" else _jax_feed
        kw = {"device": CPU} if pkg == "port" and name != "scaler" else {}
        return est.fit(feed(stream_batches), **kw)

    def manager(pkg):
        return (ShardedCheckpointManager if pkg == "port" else JShardedCheckpointManager)(str(tmp_path / "ckpt"))

    def state(model):
        return {"lr": ("coefficient",), "kmeans": ("centroids", "weights"), "scaler": ("mean", "std")}[name]

    clean = fit(reader, batches)
    clean.advance()
    crashed = fit(writer, batches[:5], manager(writer))
    assert crashed.advance() == 5
    resumed = fit(reader, batches, manager(reader))
    first = 4 if name != "scaler" else 3  # interval 2: version 4 restored (the scaler counts from 0)
    assert resumed.model_version == first
    resumed.advance()
    assert resumed.version_history == list(range(first + 1, clean.model_version + 1))
    for attr in state(resumed):
        got, want = getattr(resumed, attr), getattr(clean, attr)
        if name == "scaler":
            np.testing.assert_array_equal(got, want, err_msg=attr)  # host float64 in both
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=attr)


# --- saved and published models ----------------------------------------------------


def test_stage_registry_holds_the_online_stages_under_the_jax_names():
    for name in ("OnlineLogisticRegression", "OnlineLogisticRegressionModel", "OnlineKMeans", "OnlineKMeansModel",
                 "OnlineStandardScaler", "OnlineStandardScalerModel"):
        assert name in STAGE_REGISTRY
    assert len(STAGE_REGISTRY) == 35 and set(STAGE_REGISTRY) <= set(JSTAGE_REGISTRY)
    for name in STAGE_REGISTRY:
        assert rw.jax_class_name(get_stage_class(name)) == JSTAGE_REGISTRY[name], name


def test_online_models_saved_by_jax_load_in_the_port(tmp_path):
    stream = _jax_feed([_lr_batch(seed=1), _lr_batch(seed=2)])
    jm = JOnlineLogisticRegression().set_initial_model_data(
        JDataFrame(["coefficient"], None, [[JDenseVector(np.zeros(4))]])).fit(stream)
    jm.advance()
    jm.save(str(tmp_path / "lr"))
    pm = rw.load_stage(str(tmp_path / "lr"))
    assert type(pm) is OnlineLogisticRegressionModel and pm.model_version == 2
    np.testing.assert_array_equal(pm.coefficient, jm.coefficient)
    assert isinstance(load_servable(str(tmp_path / "lr")), LogisticRegressionModelServable)
    ts = np.asarray([10.0, 150.0])
    jstream_ = jonline.QueueBatchStream().add(JDataFrame.from_dict({"input": np.asarray([[1.0], [5.0]]),
                                                                    TIMESTAMP_COL: ts}))
    js = JOnlineStandardScaler().set_windows(jwindows.EventTimeTumblingWindows.of(100)).fit(jstream_)
    js.advance()
    js.transform(JDataFrame.from_dict({"input": np.asarray([[2.0]]), TIMESTAMP_COL: np.asarray([900.0])}))
    assert js.pending_rows == 1
    js.save(str(tmp_path / "scaler"))
    ps = OnlineStandardScalerModel.load(str(tmp_path / "scaler"))
    assert (ps.model_version, ps.model_timestamp, ps.pending_rows) == (1, 150.0, 1)
    np.testing.assert_array_equal(ps.mean, js.mean)
    with pytest.raises(ValueError, match="no port class"):
        load_servable(str(tmp_path / "scaler"))


def _serve_published(server, X, coef, version):
    resp = server.predict(DataFrame.from_dict({"features": X}))
    assert resp.model_version == version
    margin = X.astype(np.float32).astype(np.float64) @ np.asarray(coef, np.float32).astype(np.float64)
    p = 1.0 / (1.0 + np.exp(-margin))
    np.testing.assert_allclose(resp.dataframe["rawPrediction"], np.stack([1 - p, p], axis=1), rtol=0, atol=1e-6)


def test_jax_and_port_published_online_lr_serve_through_the_port_poller(tmp_path):
    d = str(tmp_path / "models")
    jstream_ = _jax_feed([_lr_batch(seed=5)], close=False)
    jm = JOnlineLogisticRegression().set_initial_model_data(
        JDataFrame(["coefficient"], None, [[JDenseVector(np.zeros(4))]])).fit(jstream_)
    jm.advance()
    jpublish_servable(jm, d)
    X = np.random.default_rng(3).normal(size=(9, 4))
    server = InferenceServer(name="online-publish", serving_config=ServingConfig(max_batch_size=16),
                             warmup_template=DataFrame.from_dict({"features": X[:1]}), device=CPU)
    poller = server.attach_poller(d, interval_ms=5, start=False)
    with server:
        assert poller.poll_once() == 1
        _serve_published(server, X, jm.coefficient, 1)
        stream = _port_feed([_lr_batch(seed=5), _lr_batch(seed=6)], close=False)
        pm = (OnlineLogisticRegression().set_initial_model_data(_init_lr_model_data())
              .fit(stream, device=CPU))
        pm.advance()
        assert pm.model_version == 2
        publish_servable(pm, d)
        assert poller.poll_once() == 2
        assert not poller.failed
        _serve_published(server, X, pm.coefficient, 2)
    assert jrw.load_metadata(os.path.join(d, "v-2"))["modelVersion"] == 2
