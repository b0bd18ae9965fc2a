"""The port's mesh-sharded plan tier (``servable/sharding.py``) on the CPU,
a twin of each function of the JAX package's ``tests/test_sharded_plans.py``:

- the mesh bucket ladder, the padding and the ragged-tail decisions equal the
  JAX ``PlanSharding``'s for N 2/4/8;
- serving and batch results at ``mesh`` N (2/4/8 shards on the CPU, the role
  the JAX tests' forced host devices play) are bit-identical per row to mesh
  1, at widths 8/16/256, in both fusion tiers, across hot swap and rollback —
  with no chain built and no model array uploaded after warmup;
- the port's sharded plans agree with the JAX package's at the same N within
  the unsharded parity tests' envelope;
- tensor parallelism (``mesh.model``) stays within rtol 1e-5, atol 1e-6 of
  mesh 1, and narrow arrays stay replicated.

The JAX tests' span-attribute checks wait for the port's tracer (ROADMAP
A 10); the batcher's ``(rows, bucket)`` history and the shard counters carry
the same facts here.
"""
import threading

import numpy as np
import pytest
import torch

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.sharding import resolve_plan_sharding as jax_resolve_plan_sharding
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.builder.batch_plan import CompiledBatchPlan
from flink_ml_tpu_torch.builder.pipeline import PipelineModel
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.ops.tensor_parallel import ColumnShards
from flink_ml_tpu_torch.servable import (
    KMeansModelServable,
    LogisticRegressionModelServable,
    MLPClassifierModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
)
from flink_ml_tpu_torch.servable import planner, sharding as sharding_mod
from flink_ml_tpu_torch.servable.fusion import ULP_ENVELOPE, ulp_diff
from flink_ml_tpu_torch.servable.sharding import (
    MIN_SHARD_ROWS,
    TP_MIN_WIDTH,
    PlanSharding,
    resolve_plan_sharding,
)
from flink_ml_tpu_torch.serving import CompiledServingPlan, InferenceServer, ServingConfig, pad_to
from flink_ml_tpu_torch.serving.plan import chain_kinds

torch.set_num_threads(1)

CPU = "cpu"
TIERS = ("exact", "fast")


@pytest.fixture(autouse=True)
def _unset_config():
    yield
    for opt in (Options.FUSION_MODE, Options.FUSION_MEGAKERNEL_MIN_SCORE, Options.BATCH_CHUNK_ROWS,
                Options.BATCH_MESH, Options.BATCH_MESH_MODEL):
        config.unset(opt)
    jconfig.unset(JOptions.BATCH_CHUNK_ROWS)


def _tier(mode):
    """Both packages at ``mode``; the fast tier takes the megakernel from
    the first bucket (its CPU wrappers run the plain versions)."""
    config.set(Options.FUSION_MODE, mode)
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, 1.0)


def _pipe(dim, seed=0, *, jax=False):
    """scaler → logistic → kmeans, the JAX test's pipeline, in either package."""
    cls = (jlib.StandardScalerModelServable, jlib.LogisticRegressionModelServable,
           jlib.KMeansModelServable, JPipeline) if jax else (
        StandardScalerModelServable, LogisticRegressionModelServable, KMeansModelServable,
        PipelineModelServable)
    rng = np.random.default_rng(seed)
    sc = cls[0]().set_input_col("features").set_output_col("scaled")
    sc.mean = rng.normal(size=dim)
    sc.std = np.abs(rng.normal(size=dim)) + 0.5
    sc.set_with_mean(True)
    lr = cls[1]().set_features_col("scaled")
    lr.coefficient = rng.normal(size=dim)
    km = cls[2]().set_features_col("scaled").set_prediction_col("cluster")
    km.centroids = rng.normal(size=(3, dim))
    km.weights = np.ones(3)
    return cls[3]([sc, lr, km])


def _features(n, dim, seed=3, frame=DataFrame):
    return frame.from_dict({"features": np.random.default_rng(seed).normal(size=(n, dim))})


def _assert_frames_bitexact(a, b):
    assert a.get_column_names() == b.get_column_names()
    for name in a.get_column_names():
        ca, cb = np.asarray(a[name]), np.asarray(b[name])
        assert ca.dtype == cb.dtype, name
        np.testing.assert_array_equal(ca, cb, err_msg=name)


# ---------------------------------------------------------------------------
# sharding vocabulary
# ---------------------------------------------------------------------------


class TestPlanSharding:
    def test_resolve_mesh_1_is_none(self):
        assert resolve_plan_sharding(1, device=CPU) is None
        assert resolve_plan_sharding(None, device=CPU) is None
        assert resolve_plan_sharding(0, 1, device=CPU) is None
        assert resolve_plan_sharding(1, 2, device=CPU).key == (1, 2)

    def test_resolve_too_many_devices_raises(self):
        """The JAX package raises on a mesh wider than its devices; the port
        places every shard on the plan's device and keeps the local shapes
        of the mesh asked for (``servable/sharding.py``), so it does not."""
        sh = resolve_plan_sharding(16, device=CPU)
        assert sh.key == (16, 1) and sh.row_multiple == 16 * MIN_SHARD_ROWS
        assert sh.devices == (torch.device("cpu"),) * 16
        assert "devices=[cpu" in repr(sh)
        parts = sh.put_batch(np.arange(256, dtype=np.float32).reshape(128, 2))
        assert [tuple(p.shape) for p in parts] == [(8, 2)] * 16
        with pytest.raises(ValueError):
            sh.put_batch(np.zeros((12, 2), np.float32))  # not a multiple of the data axis
        with pytest.raises(ValueError):
            PlanSharding(0, 1, CPU)

    def test_grid_starts_at_the_plan_devices_index(self, monkeypatch):
        """On CUDA shard i goes on ``cuda:((base + i) mod count)``: shard 0 on
        the device the plan was asked for, the rest wrapping round the cards."""
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        cuda = [torch.device("cuda", i) for i in range(4)]
        assert sharding_mod._grid_devices(4, cuda[1]) == (cuda[1], cuda[2], cuda[3], cuda[0])
        assert sharding_mod._grid_devices(6, cuda[3]) == (cuda[3], cuda[0], cuda[1], cuda[2], cuda[3], cuda[0])
        assert sharding_mod._grid_devices(2, cuda[0]) == (cuda[0], cuda[1])
        assert sharding_mod._grid_devices(3, torch.device("cpu")) == (torch.device("cpu"),) * 3

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_bucket_ladder_is_mesh_quantized(self, n):
        sh, ref = resolve_plan_sharding(n, device=CPU), jax_resolve_plan_sharding(n)
        for max_batch in (64, 128, 4096):
            buckets = sh.serving_buckets(max_batch)
            assert buckets == ref.serving_buckets(max_batch)
            assert buckets[-1] == max_batch and buckets[0] == MIN_SHARD_ROWS * n
            assert all(b % (MIN_SHARD_ROWS * n) == 0 for b in buckets)

    def test_bucket_ladder_rejects_sub_quantum_max(self):
        sh, ref = resolve_plan_sharding(4, device=CPU), jax_resolve_plan_sharding(4)
        for bad in (16, 40):  # < 8 * 4, not a multiple of 32
            with pytest.raises(ValueError):
                sh.serving_buckets(bad)
            with pytest.raises(ValueError):
                ref.serving_buckets(bad)

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_padding_and_shardability(self, n):
        sh, ref = resolve_plan_sharding(n, device=CPU), jax_resolve_plan_sharding(n)
        assert sh.row_multiple == ref.row_multiple == MIN_SHARD_ROWS * n
        for rows in range(1, 300):
            assert sh.padded_rows(rows) == ref.padded_rows(rows), rows
            assert sh.shardable_rows(rows) == ref.shardable_rows(rows), rows
        assert (sh.padded_rows(33), sh.shardable_rows(40), sh.shardable_rows(36)) == (
            ref.padded_rows(33), True, False)


@pytest.mark.parametrize("dim", [8, 16, 100, 256])
def test_row_stable_bodies_keep_a_rows_bits_at_every_shard_size(dim):
    """The serving bodies give a row the same bits in a block of 8, 16 or
    24 rows as inside 4096 (``ops/rowstable.py``): MKL's 8-row product with
    a transposed operand and ATen's scalar-tail sigmoid would not."""
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.ops.distance import DistanceMeasure

    g = torch.Generator().manual_seed(dim)
    X, coef = torch.randn(4096, dim, generator=g), torch.randn(dim, generator=g)
    C, W = torch.randn(10, dim, generator=g), torch.randn(dim, 128, generator=g)
    bodies = {
        "dot": lambda x: K.dot_fn(x, coef),
        "logistic": lambda x: K.logistic_from_dots_fn(x @ coef)[1],
        "normalize": lambda x: K.normalize_fn(x, 2.0),
        "mlp": lambda x: K.mlp_predict_fn([(W, torch.zeros(128)), (W.T[:, :4] / 10, torch.zeros(4))], x)[1],
        **{m: (lambda x, m=m: DistanceMeasure.get_instance(m).pairwise(x, C, stable=True))
           for m in ("euclidean", "manhattan", "cosine")},
    }
    for name, fn in bodies.items():
        full = fn(X)
        for m in (8, 16, 24):
            for lo in range(0, 4096 - m + 1, 1000 // m * m):
                assert torch.equal(fn(X[lo:lo + m].clone()), full[lo:lo + m]), (name, m, lo)


def test_cuda_takes_the_row_stable_forms_only_inside_required(monkeypatch):
    """A CUDA tensor (a meta tensor stands in: any device but the CPU) takes
    cuBLAS's product and ATen's row sum outside ``rowstable.required()`` and
    the fixed-order fold inside it; the block is per thread, nests, and
    ``required(False)`` leaves it as it is. The CPU always takes its forms."""
    from flink_ml_tpu_torch.ops import rowstable

    folds = []
    fold = rowstable.fold_sum
    monkeypatch.setattr(rowstable, "fold_sum", lambda t, dim=-1: folds.append(dim) or fold(t, dim))
    a, w, v = (torch.empty(32, 16, device="meta"), torch.empty(16, 8, device="meta"),
               torch.empty(16, device="meta"))

    def calls():
        folds.clear()
        assert rowstable.matmul(a, w).shape == (32, 8)
        assert rowstable.matmul(a, v).shape == (32,)
        assert rowstable.sum_last(a).shape == (32,)
        return len(folds)

    assert calls() == 0
    with rowstable.required():
        assert calls() == 3
        with rowstable.required(False):
            assert calls() == 3
        seen = []
        th = threading.Thread(target=lambda: seen.append(calls()))
        th.start()
        th.join()
        assert seen == [0]
    with rowstable.required(False):
        assert calls() == 0
    assert calls() == 0
    x = torch.randn(8, 16)
    assert torch.equal(rowstable.sum_last(x), x.sum(-1))
    rowstable.matmul(x, torch.randn(16, 4))  # the CPU's padded product: no fold
    assert not folds


@pytest.mark.parametrize("n", [1, 2])
def test_only_a_segment_with_data_shards_runs_inside_required(n, monkeypatch):
    """``run_segment`` runs a plan's bodies inside ``rowstable.required()``
    exactly when its segment has more than one data shard: mesh 1 (and a
    ``Model.transform``) keep cuBLAS on the card."""
    from flink_ml_tpu_torch.ops import rowstable

    seen = []
    matmul = rowstable.matmul
    monkeypatch.setattr(rowstable, "matmul",
                        lambda a, b: seen.append(getattr(rowstable._state, "on", False)) or matmul(a, b))
    dim = 8
    plan = CompiledServingPlan.build(_pipe(dim), scope=f"ml.serving[t-required{n}]", device=CPU,
                                     sharding=resolve_plan_sharding(n, device=CPU))
    plan.execute(_features(32, dim))
    assert seen and set(seen) == {n > 1}
    seen.clear()
    _pipe(dim).transform(_features(32, dim), device=CPU)
    assert seen and set(seen) == {False}


# ---------------------------------------------------------------------------
# plan-level parity: sharded vs mesh 1, widths 8/16/256, both tiers
# ---------------------------------------------------------------------------


class TestShardedPlanParity:
    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("dim", [8, 16, 256])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_serving_plan_bitexact_vs_mesh1(self, dim, n, mode):
        _tier(mode)
        df = _features(64, dim, seed=dim)
        base = CompiledServingPlan.build(_pipe(dim), scope=f"ml.serving[t-sh-base{dim}]", device=CPU)
        base.warmup(df.take([0]), (16, 64))
        sh = resolve_plan_sharding(n, device=CPU)
        plan = CompiledServingPlan.build(_pipe(dim), scope=f"ml.serving[t-sh{n}-{dim}]", sharding=sh)
        buckets = sh.serving_buckets(64)
        plan.warmup(df.take([0]), buckets)
        for bucket in (16, 64):
            if bucket in buckets:
                _assert_frames_bitexact(base.execute(df.take(np.arange(bucket))),
                                        plan.execute(df.take(np.arange(bucket))))
        # one program kind per key, chosen at the bucket's rows: mesh N runs
        # what mesh 1 runs (the megakernel in the fast tier)
        kinds, base_kinds = chain_kinds(plan), chain_kinds(base)
        for bucket in (16, 64):
            if bucket in buckets:
                assert kinds[bucket] == base_kinds[bucket]
        assert ("megakernel" in kinds[64]) == (mode == "fast")

    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("dim", [8, 16, 256])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_mlp_serving_plan_bitexact_vs_mesh1(self, dim, n, mode):
        """An MLP head, whose probabilities carry every bit of its products:
        8-row shards of a 64-row bucket (mesh 8) against mesh 1."""
        _tier(mode)
        dims = [dim, 128, 4]
        df = DataFrame.from_dict({"features": np.random.default_rng(dim).normal(size=(64, dim))})
        base = CompiledServingPlan.build(_mlp(dims), scope=f"ml.serving[t-shmlp-base{dim}]", device=CPU)
        plan = CompiledServingPlan.build(_mlp(dims), scope=f"ml.serving[t-shmlp{n}-{dim}]",
                                         sharding=resolve_plan_sharding(n, device=CPU))
        _assert_frames_bitexact(base.execute(df), plan.execute(df))

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_port_sharded_plan_matches_the_jax_sharded_plan(self, n):
        """The port and the JAX package at the same mesh N: within the
        envelope the unsharded parity tests hold (``ULP_ENVELOPE``), the
        prediction and cluster equal."""
        dim = 16
        df, jdf = _features(64, dim, seed=5), _features(64, dim, seed=5, frame=JDataFrame)
        sh, jsh = resolve_plan_sharding(n, device=CPU), jax_resolve_plan_sharding(n)
        plan = CompiledServingPlan.build(_pipe(dim), scope=f"ml.serving[t-vsjax{n}]", sharding=sh)
        jplan = JPlan.build(_pipe(dim, jax=True), scope=f"ml.serving[t-vsjax{n}]", sharding=jsh)
        for bucket in sh.serving_buckets(64):
            got = plan.execute(df.take(np.arange(bucket)))
            want = jplan.execute(jdf.take(np.arange(bucket)))
            assert got.get_column_names() == want.get_column_names()
            for name in ("scaled", "rawPrediction"):
                assert ulp_diff(got[name], np.asarray(want[name])) <= ULP_ENVELOPE["scale_logistic"], name
            for name in ("prediction", "cluster"):
                np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)

    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_off_ladder_bucket_falls_back_bitexact(self, n):
        """A bucket that is not a mesh-quantum multiple cannot shard without
        changing local shapes: it serves through the counted per-stage
        fallback, bit-exactly."""
        dim = 16
        pipe = _pipe(dim)
        scope = f"ml.serving[t-offladder{n}]"
        plan = CompiledServingPlan.build(_pipe(dim), scope=scope, sharding=resolve_plan_sharding(n, device=CPU))
        df = _features(MIN_SHARD_ROWS * n + 4, dim)  # off the ladder
        before = metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES) or 0
        reason = MLMetrics.fallback_reason("serving", "off_ladder")
        before_reason = metrics.get(scope, reason) or 0
        _assert_frames_bitexact(pipe.transform(df, device=CPU), plan.execute(df))
        assert metrics.get(scope, MLMetrics.SERVING_FALLBACK_BATCHES) == before + 1
        assert metrics.get(scope, reason) == before_reason + 1


# ---------------------------------------------------------------------------
# server-level: no build and no model upload after warmup, swap + rollback
# ---------------------------------------------------------------------------


class TestShardedServer:
    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_cold_hot_path_across_swap_and_rollback(self, n, mode, monkeypatch):
        """Traffic at mesh N, bit-identical per row to the mesh 1 plan (and,
        in the exact tier, to the per-stage transform) at the response's
        bucket, across a hot swap to v2, a rollback to v1 and a swap on —
        with chain builds and model uploads poisoned for the whole traffic
        phase (weights placed on every shard at swap time)."""
        _tier(mode)
        dim = 16
        pipe_v1, pipe_v2 = _pipe(dim, seed=10), _pipe(dim, seed=20)
        refs = {1: _pipe(dim, seed=10), 2: _pipe(dim, seed=20)}
        mesh1 = {v: CompiledServingPlan.build(refs[v], scope=f"ml.serving[t-cold-ref{v}]", device=CPU)
                 for v in refs}
        cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.0, queue_capacity_rows=1024, mesh=n)
        X = np.asarray(_features(64, dim, seed=9)["features"])
        seen = []
        with InferenceServer(pipe_v1, name=f"t-shard-cold{n}-{mode}", serving_config=cfg,
                             warmup_template=_features(1, dim), device=CPU) as server:
            plans = {}
            for version, servable, flip in ((2, pipe_v2, server.swap), (1, pipe_v1, server.rollback),
                                            (2, pipe_v2, server.swap)):
                flip(version, servable)
                assert server.model_version == version
                plans[version] = servable._fastpath_plan
            with pytest.raises(ValueError, match="already serving"):
                server.rollback(2, pipe_v2)
            for plan in plans.values():
                assert plan is not None and plan.sharding is not None and plan.sharding.n_data == n
            uploads = {v: p.sharding.model_uploads for v, p in plans.items()}

            def poisoned(*a, **k):
                raise AssertionError("a build or model upload on the sharded hot path")

            monkeypatch.setattr(sharding_mod.PlanSharding, "put_model", poisoned)
            monkeypatch.setattr(planner.FusedSegment, "__init__", poisoned)
            for k in range(6):
                rows = (k % 3) + 1
                df = DataFrame.from_dict({"features": X[k:k + rows]})
                resp = server.predict(df)
                seen.append(resp.model_version)
                padded = pad_to(df, resp.bucket)
                expected = mesh1[resp.model_version].execute(padded).take(np.arange(rows))
                _assert_frames_bitexact(resp.dataframe, expected)
                if mode == "exact":
                    per_stage = refs[resp.model_version].transform(padded, device=CPU)
                    _assert_frames_bitexact(resp.dataframe, per_stage.take(np.arange(rows)))
                assert resp.bucket % (MIN_SHARD_ROWS * n) == 0
            assert {v: p.sharding.model_uploads for v, p in plans.items()} == uploads
            scope = server.scope
        assert not metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES)
        assert metrics.get(scope, MLMetrics.SERVING_SHARD_COUNT) == n
        assert metrics.get(scope, MLMetrics.SERVING_SHARD_ROWS) > 0
        assert set(seen) == {2}

    @pytest.mark.parametrize("n", [2, 4])
    def test_mesh_bucket_rows_attrs_stay_exact(self, n):
        """The batcher's (rows, bucket) history holds the TRUE request rows
        against the mesh-padded bucket, and the shard counter the bucket's
        rows per shard."""
        dim = 8
        cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.0, mesh=n)
        with InferenceServer(_pipe(dim), name=f"t-shard-attrs{n}", serving_config=cfg,
                             warmup_template=_features(1, dim), device=CPU) as server:
            assert server._batcher.buckets == resolve_plan_sharding(n, device=CPU).serving_buckets(64)
            before = metrics.get(server.scope, MLMetrics.SERVING_SHARD_ROWS) or 0
            server.predict(_features(3, dim))
            sizes = server.executed_batch_sizes
            assert metrics.get(server.scope, MLMetrics.SERVING_SHARD_ROWS) - before == MIN_SHARD_ROWS
        assert sizes == [(3, MIN_SHARD_ROWS * n)]

    def test_mesh1_default_unchanged(self):
        """serving.mesh default (1) keeps the power-of-two buckets and an
        unsharded plan, with the JAX package's defaults."""
        assert (Options.SERVING_MESH.default, Options.SERVING_MESH_MODEL.default) == (
            JOptions.SERVING_MESH.default, JOptions.SERVING_MESH_MODEL.default) == (1, 1)
        assert Options.SERVING_MESH.env_var == JOptions.SERVING_MESH.env_var
        dim = 8
        cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.0)
        assert (cfg.mesh, cfg.mesh_model) == (1, 1)
        pipe = _pipe(dim)
        with InferenceServer(pipe, name="t-mesh1", serving_config=cfg,
                             warmup_template=_features(1, dim), device=CPU) as server:
            assert server._batcher.buckets == (1, 2, 4, 8, 16, 32, 64)
            server.predict(_features(2, dim))
            assert pipe._fastpath_plan.sharding is None

    def test_a_grid_not_starting_on_the_servers_device_does_not_rebuild(self, monkeypatch):
        """A sharded plan's own device is its first shard's, which need not
        be the server's (here ``cpu:0`` against ``cpu``): the stale-plan
        check compares shard grids, so after warmup the batcher's thread
        builds no chain and uploads no model array."""
        from flink_ml_tpu_torch.serving import server as server_mod

        dim = 8
        grid = PlanSharding(2, 1, ("cpu:0", "cpu:0"))
        assert grid.devices[0] != torch.device(CPU)
        monkeypatch.setattr(server_mod, "resolve_plan_sharding", lambda *a, **k: grid)
        pipe = _pipe(dim, seed=6)
        mesh1 = CompiledServingPlan.build(_pipe(dim, seed=6), scope="ml.serving[t-grid-device-ref]", device=CPU)
        cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.0, mesh=2)
        with InferenceServer(pipe, name="t-grid-device", serving_config=cfg,
                             warmup_template=_features(1, dim), device=CPU) as server:
            plan = pipe._fastpath_plan
            assert plan.sharding is grid and plan.device != server.device

            def poisoned(*a, **k):
                raise AssertionError("a build or model upload after warmup")

            monkeypatch.setattr(sharding_mod.PlanSharding, "put_model", poisoned)
            monkeypatch.setattr(planner.FusedSegment, "__init__", poisoned)
            for rows in (1, 5, 16, 40):
                df = _features(rows, dim, seed=rows)
                resp = server.predict(df)
                assert pipe._fastpath_plan is plan
                want = mesh1.execute(pad_to(df, resp.bucket)).take(np.arange(rows))
                _assert_frames_bitexact(resp.dataframe, want)
            scope = server.scope
        assert not metrics.get(scope, MLMetrics.SERVING_FASTPATH_COMPILES)

    def test_plan_rebuilds_when_mesh_changes(self):
        """The same servable served on servers with different meshes does
        not reuse a plan built for the other placement."""
        dim = 8
        pipe = _pipe(dim)
        with InferenceServer(pipe, name="t-remesh-a", device=CPU,
                             serving_config=ServingConfig(max_batch_size=64, max_delay_ms=0.0),
                             warmup_template=_features(1, dim)) as a:
            a.predict(_features(2, dim))
            assert pipe._fastpath_plan.sharding is None
        with InferenceServer(pipe, name="t-remesh-b", device=CPU,
                             serving_config=ServingConfig(max_batch_size=64, max_delay_ms=0.0, mesh=2),
                             warmup_template=_features(1, dim)) as b:
            b.predict(_features(2, dim))
            assert pipe._fastpath_plan.sharding is not None
            assert pipe._fastpath_plan.sharding.n_data == 2
            assert "sharding=PlanSharding(data=2" in repr(pipe._fastpath_plan)

    def test_concurrent_sharded_traffic_bitexact(self):
        dim = 16
        pipe, ref = _pipe(dim, seed=4), _pipe(dim, seed=4)
        cfg = ServingConfig(max_batch_size=64, max_delay_ms=1.0, queue_capacity_rows=2048,
                            default_timeout_ms=60_000, mesh=4)
        X = np.asarray(_features(64, dim, seed=5)["features"])
        results, errors = {}, []
        with InferenceServer(pipe, name="t-shard-soak", serving_config=cfg,
                             warmup_template=_features(1, dim), device=CPU) as server:

            def client(tid):
                try:
                    for i in range(16):
                        j = (tid * 17 + i * 5) % X.shape[0]
                        results[(tid, i)] = (j, server.predict(DataFrame.from_dict({"features": X[j:j + 1]})))
                except BaseException as e:  # noqa: BLE001 — surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 64
        for j, resp in results.values():
            expected = ref.transform(pad_to(DataFrame.from_dict({"features": X[j:j + 1]}), resp.bucket),
                                     device=CPU).take([0])
            _assert_frames_bitexact(resp.dataframe, expected)


# ---------------------------------------------------------------------------
# batch transform: sharded chunks, ragged tails
# ---------------------------------------------------------------------------


class TestShardedBatchPlan:
    def _stages(self, dim, seed=0):
        rng = np.random.default_rng(seed)
        sc = StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
        sc.mean = rng.normal(size=dim)
        sc.std = np.abs(rng.normal(size=dim)) + 0.5
        sc.set_with_mean(True)
        lr = LogisticRegressionModelServable().set_features_col("scaled")
        lr.coefficient = rng.normal(size=dim)
        return [sc, lr]

    @pytest.mark.parametrize("mode", TIERS)
    @pytest.mark.parametrize("dim", [8, 16, 256])
    @pytest.mark.parametrize("n", [2, 4, 8])
    def test_chunked_bitexact_vs_mesh1(self, dim, n, mode):
        _tier(mode)
        stages = self._stages(dim, seed=dim)
        df = DataFrame.from_dict({"features": np.random.default_rng(dim).normal(size=(200, dim))})
        config.set(Options.BATCH_CHUNK_ROWS, 64)
        base = CompiledBatchPlan.build(stages, scope=f"ml.batch[t-b{dim}-1]", device=CPU).transform(df)
        plan = CompiledBatchPlan.build(stages, scope=f"ml.batch[t-b{dim}-{n}]",
                                       sharding=resolve_plan_sharding(n, device=CPU))
        _assert_frames_bitexact(base, plan.transform(df))
        # the 8-row tail (200 = 3·64 + 8) pads to the mesh quantum
        assert any(key[-1] != "replicated" for seg in plan.segments for key in seg.compiled)

    @pytest.mark.parametrize("tail,expect", [
        (8, "sharded"),      # a multiple of MIN_SHARD_ROWS: pads up to the quantum
        (36, "replicated"),  # remainder rows: runs at mesh 1's shape
        (3, "replicated"),
    ])
    def test_ragged_tail_policy(self, tail, expect):
        n, dim = 4, 16
        stages = self._stages(dim)
        df = DataFrame.from_dict({"features": np.random.default_rng(1).normal(size=(64 + tail, dim))})
        scope = f"ml.batch[t-tail{tail}]"
        config.set(Options.BATCH_CHUNK_ROWS, 64)
        base = CompiledBatchPlan.build(stages, scope="ml.batch[t-tailbase]", device=CPU).transform(df)
        sh, jsh = resolve_plan_sharding(n, device=CPU), jax_resolve_plan_sharding(n)
        out = CompiledBatchPlan.build(stages, scope=scope, sharding=sh).transform(df)
        _assert_frames_bitexact(base, out)
        pad = metrics.get(scope, MLMetrics.BATCH_SHARD_PAD_ROWS)
        repl = metrics.get(scope, MLMetrics.BATCH_SHARD_REPLICATED_CHUNKS)
        assert (expect == "sharded") == jsh.shardable_rows(tail) == sh.shardable_rows(tail)
        if expect == "sharded":
            assert pad == jsh.padded_rows(tail) - tail and not repl
        else:
            assert repl == 1 and not pad

    def test_chunk_span_attrs_split_padding_once(self):
        """Chunk rows against the padded shape each ran at: 64 rows at 64 and
        an 8-row tail at 32 (24 pad rows, counted once); every chunk split
        over the 4 shards."""
        n, dim = 4, 8
        stages = self._stages(dim)
        df = DataFrame.from_dict({"features": np.random.default_rng(2).normal(size=(72, dim))})
        config.set(Options.BATCH_CHUNK_ROWS, 64)
        scope = "ml.batch[t-attrs]"
        plan = CompiledBatchPlan.build(stages, scope=scope, sharding=resolve_plan_sharding(n, device=CPU))
        plan.transform(df)
        (segment,) = plan.segments
        assert sorted(sig["features"][0][0] for sig in segment.signatures.values()) == [32, 64]
        assert metrics.get(scope, MLMetrics.BATCH_SHARD_ROWS) == (64 + 32) // n
        assert metrics.get(scope, MLMetrics.BATCH_SHARD_PAD_ROWS) == 24
        assert metrics.get(scope, MLMetrics.BATCH_SHARD_COUNT) == n
        assert not metrics.get(scope, MLMetrics.BATCH_SHARD_REPLICATED_CHUNKS)

    def test_pipeline_model_config_route(self):
        """PipelineModel.transform picks up batch.mesh from config and the
        plan cache rebuilds when the mesh changes."""
        dim = 8
        model = PipelineModel(self._stages(dim))
        df = DataFrame.from_dict({"features": np.random.default_rng(3).normal(size=(48, dim))})
        base = model.transform(df, device=CPU)
        assert model._plan_cache[1].sharding is None
        config.set(Options.BATCH_MESH, 2)
        out = model.transform(df, device=CPU)
        plan = model._plan_cache[1]
        assert plan is not None and plan.sharding is not None and plan.sharding.n_data == 2
        _assert_frames_bitexact(base, out)


# ---------------------------------------------------------------------------
# tensor parallelism: the envelope tier
# ---------------------------------------------------------------------------


def _mlp(dims, jax=False):
    rng = np.random.default_rng(7)
    arrays = {}
    for i in range(len(dims) - 1):
        arrays[f"W{i}"] = rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32) * 0.3
        arrays[f"b{i}"] = rng.normal(size=(dims[i + 1],)).astype(np.float32) * 0.1
    arrays["labels"] = np.arange(dims[-1]).astype(np.float64)
    cls = jlib.MLPClassifierModelServable if jax else MLPClassifierModelServable
    return cls().set_features_col("features")._apply_model_arrays(arrays)


class TestTensorParallel:
    def test_tp_wide_head_within_ulp_envelope(self):
        dims = [32, 128, 128, 4]
        X = np.random.default_rng(1).normal(size=(64, 32))
        df = DataFrame.from_dict({"features": X})
        base = CompiledServingPlan.build(_mlp(dims), scope="ml.serving[t-tp-base]", device=CPU)
        expected = base.execute(df)
        sh = PlanSharding(2, 2, CPU)  # DP 2 x TP 2
        plan = CompiledServingPlan.build(_mlp(dims), scope="ml.serving[t-tp]", sharding=sh)
        plan.warmup(df.take([0]), sh.serving_buckets(64))
        out = plan.execute(df)
        (segment,) = plan.segments
        split = {k for k, v in segment.shard_models[0][0].items() if isinstance(v, ColumnShards)}
        assert split == {"W0", "W1"}  # W2 is 4 wide, the biases 1-D: replicated
        raw_a, raw_b = np.asarray(expected["rawPrediction"]), np.asarray(out["rawPrediction"])
        np.testing.assert_allclose(raw_b, raw_a, rtol=1e-5, atol=1e-6)
        # against a float64 forward and the JAX package's 2 x 2 plan
        h = X
        mlp = _mlp(dims)
        for W, b in mlp.layers[:-1]:
            h = np.maximum(h @ W.astype(np.float64) + b, 0.0)
        logits = h @ mlp.layers[-1][0].astype(np.float64) + mlp.layers[-1][1]
        p64 = np.exp(logits - logits.max(1, keepdims=True))
        p64 /= p64.sum(1, keepdims=True)
        np.testing.assert_allclose(raw_b, p64, rtol=1e-4, atol=1e-6)
        jplan = JPlan.build(_mlp(dims, jax=True), scope="ml.serving[t-tp-jax]",
                            sharding=jax_resolve_plan_sharding(2, 2))
        want = np.asarray(jplan.execute(JDataFrame.from_dict({"features": X}))["rawPrediction"])
        np.testing.assert_allclose(raw_b, want, rtol=1e-5, atol=1e-6)
        assert metrics.get("ml.serving[t-tp]", MLMetrics.SERVING_SHARD_MODEL_AXIS) == 2

    def test_tp_kmeans_centroids_split_along_d(self):
        """KMeans' [k, d] centroids at d 256 split along d over the model
        axis; the partial sums add in model-shard order, within the envelope
        of mesh 1 (distances) and equal clusters on these rows."""
        dim = 256
        km = _pipe(dim).servables[2]
        X = np.random.default_rng(2).normal(size=(64, dim))
        df = DataFrame.from_dict({"scaled": X})
        base = CompiledServingPlan.build(km, scope="ml.serving[t-tpkm-base]", device=CPU).execute(df)
        sh = PlanSharding(2, 4, CPU)
        plan = CompiledServingPlan.build(_pipe(dim).servables[2], scope="ml.serving[t-tpkm]", sharding=sh)
        (segment,) = plan.segments
        assert isinstance(segment.shard_models[1][0]["centroids"], ColumnShards)
        np.testing.assert_array_equal(np.asarray(plan.execute(df)["cluster"]), np.asarray(base["cluster"]))
        from flink_ml_tpu_torch.ops.distance import DistanceMeasure

        cents = torch.from_numpy(km.centroids.astype(np.float32))
        pts = torch.from_numpy(X.astype(np.float32))
        split = ColumnShards(torch.chunk(cents, 4, dim=1))
        for name in ("euclidean", "manhattan", "cosine"):
            m = DistanceMeasure.get_instance(name)
            np.testing.assert_allclose(m.pairwise(pts, split).numpy(), m.pairwise(pts, cents).numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)

    def test_tp_narrow_arrays_stay_replicated(self):
        sh = PlanSharding(2, 2, CPU)
        narrow = np.ones((16, 8), np.float32)  # < TP_MIN_WIDTH: replicated
        wide = np.ones((16, 2 * TP_MIN_WIDTH), np.float32)
        odd = np.ones((16, TP_MIN_WIDTH + 1), np.float32)  # does not divide by 2
        put = sh.put_model(narrow)
        assert len(put) == 2 and put[0] is put[1] and tuple(put[0].shape) == (16, 8)
        assert not isinstance(sh.put_model(odd)[0], ColumnShards)
        pieces = sh.put_model(wide)
        assert isinstance(pieces[0], ColumnShards) and pieces[0].shape == (16, 2 * TP_MIN_WIDTH)
        assert [tuple(p.shape) for p in pieces[0]] == [(16, TP_MIN_WIDTH)] * 2
        assert pieces[0][0] is pieces[1][0]  # one upload per distinct device
        assert sh.model_uploads == 1 + 1 + 2
        assert PlanSharding(1, 2, CPU).put_model(np.ones(128, np.float32))[0].dim() == 1
