"""Metrics — the counters and gauges the plan, batcher, server and
checkpoint manager bump.

Twin of ``flink_ml_tpu/metrics.py``, cut to the names the serving path, the
batch plan, the checkpoint managers and the sharded trainers publish; each name is identical to
the JAX package's, so dashboards and tests read both packages the same way.
A process-local registry of named gauges, counters and histograms grouped
per scope (``ml.serving[<name>]``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["MLMetrics", "Histogram", "MetricsRegistry", "metrics"]


class MLMetrics:
    TIMESTAMP = "ml.model.timestamp"
    VERSION = "ml.model.version"

    # Checkpoint-failover counters (scope = CHECKPOINT_GROUP, process-global).
    CHECKPOINT_GROUP = "ml.checkpoint"
    CHECKPOINT_QUARANTINED = "ml.checkpoint.quarantined"
    CHECKPOINT_FALLBACKS = "ml.checkpoint.fallbacks"
    CHECKPOINT_TMP_SWEPT = "ml.checkpoint.tmp.swept"
    CHECKPOINT_SHARD_PIECES = "ml.checkpoint.shard.pieces"  # per-shard leaves written, counter

    # Sharded-training counters (scope = TRAIN_GROUP, process-global:
    # parallel/train_sharding.py). Each rank counts its own process's fits.
    TRAIN_GROUP = "ml.train"
    TRAIN_SHARD_INGEST_ROWS = "ml.train.shard.ingest.rows"  # rows dealt onto the mesh, counter
    TRAIN_SHARD_PAD_ROWS = "ml.train.shard.pad.rows"  # zero-mask padding rows, counter
    TRAIN_SHARDED_FITS = "ml.train.sharded.fits"  # fits run on the deterministic tier, counter

    # Online-serving runtime (scope = "ml.serving[<server name>]").
    SERVING_GROUP = "ml.serving"
    SERVING_QUEUE_DEPTH = "ml.serving.queue.depth"  # rows waiting, gauge
    SERVING_REQUESTS = "ml.serving.requests"  # admitted, counter
    SERVING_BATCHES = "ml.serving.batches"  # executed batches, counter
    SERVING_REJECTED = "ml.serving.rejected"  # ServingOverloadedError, counter
    SERVING_TIMEOUTS = "ml.serving.timeouts"  # deadline expiries, counter
    SERVING_SWAPS = "ml.serving.swaps"  # hot model swaps, counter
    SERVING_SWAP_FAILURES = "ml.serving.swap.failures"  # rejected versions, counter
    SERVING_POLL_ERRORS = "ml.serving.poll.errors"  # poller scan failures, counter
    SERVING_BATCH_SIZE = "ml.serving.batch.size"  # pre-padding rows, histogram
    SERVING_LATENCY_MS = "ml.serving.latency.ms"  # enqueue→response, histogram
    SERVING_LATENCY_P50_MS = "ml.serving.latency.p50.ms"  # gauge from histogram
    SERVING_LATENCY_P99_MS = "ml.serving.latency.p99.ms"  # gauge from histogram

    # Serving fast path (serving/plan.py — per-bucket chains).
    SERVING_FUSED_STAGES = "ml.serving.fastpath.fused.stages"  # stages fused, gauge
    SERVING_FALLBACK_STAGES = "ml.serving.fastpath.fallback.stages"  # per-stage, gauge
    SERVING_FUSED_BATCHES = "ml.serving.fastpath.fused.batches"  # fused executions, counter
    SERVING_FALLBACK_BATCHES = "ml.serving.fastpath.fallback.batches"  # ineligible batches, counter
    SERVING_FASTPATH_COMPILES = "ml.serving.fastpath.compiles"  # chains built after warmup (0 = healthy), counter
    SERVING_WARMUP_COMPILE_MS = "ml.serving.fastpath.warmup.compile.ms"  # warmup wall time, gauge
    SERVING_INFLIGHT_DEPTH = "ml.serving.inflight.depth"  # dispatched-not-finalized batches, gauge

    # Mesh-sharded serving (serving.mesh > 1 — servable/sharding.py).
    SERVING_SHARD_COUNT = "ml.serving.shard.count"  # data-axis width of the plan's mesh, gauge
    SERVING_SHARD_MODEL_AXIS = "ml.serving.shard.model.axis"  # tensor-parallel width, gauge
    SERVING_SHARD_ROWS = "ml.serving.shard.rows"  # per-shard rows through fused batches, counter

    # Fusion tier of the compiled plans (fusion.mode).
    FUSION_MODE = "ml.fusion.mode"  # 0 = exact, 1 = fast, gauge
    FUSION_PROGRAMS_EXACT = "ml.fusion.programs.exact"  # exact-partition programs built, counter
    FUSION_PROGRAMS_FUSED = "ml.fusion.programs.fused"  # cross-reduction programs built, counter
    FUSION_PROGRAMS_MEGAKERNEL = "ml.fusion.programs.megakernel"  # megakernel programs built, counter
    FUSION_PLAN_CHOICE = "ml.fusion.plan.choice"  # 0 exact / 1 fused / 2 megakernel, gauge
    FUSION_PLAN_SCORE = "ml.fusion.plan.score"  # cost-model score of the last built chain, gauge

    # Batch transform fast path (builder/batch_plan.py — scope "ml.batch[plan]").
    BATCH_FUSED_STAGES = "ml.batch.fastpath.fused.stages"  # stages fused, gauge
    BATCH_FALLBACK_STAGES = "ml.batch.fastpath.fallback.stages"  # per-stage, gauge
    BATCH_FUSED_CHUNKS = "ml.batch.fastpath.fused.chunks"  # chunk executions, counter
    BATCH_FUSED_ROWS = "ml.batch.fastpath.fused.rows"  # rows through fused chains, counter
    BATCH_FALLBACK_SEGMENTS = "ml.batch.fastpath.fallback.segments"  # ineligible segment runs, counter
    BATCH_COMPILES = "ml.batch.fastpath.compiles"  # chains built (one per new chunk signature), counter
    BATCH_PLAN_BUILD_MS = "ml.batch.fastpath.plan.build.ms"  # build + model upload wall time, gauge
    BATCH_CHUNK_MS = "ml.batch.fastpath.chunk.ms"  # dispatch→readback per chunk, histogram

    # Mesh-sharded batch transform (batch.mesh > 1 — servable/sharding.py).
    BATCH_SHARD_COUNT = "ml.batch.shard.count"  # data-axis width of the plan's mesh, gauge
    BATCH_SHARD_ROWS = "ml.batch.shard.rows"  # per-shard rows through sharded chunks, counter
    BATCH_SHARD_PAD_ROWS = "ml.batch.shard.pad.rows"  # DP round-up pad rows on ragged chunks, counter
    BATCH_SHARD_REPLICATED_CHUNKS = "ml.batch.shard.replicated.chunks"  # tails run replicated, counter

    #: Reason labels of the per-reason fast-path fallback counters: a sparse
    #: column where the segment expects a dense kind, a column that is not a
    #: dense numeric array, a batch whose nnz exceeds ``sparse.nnz.cap.max``,
    #: a shape differing from the key's recorded one, a stage with no spec.
    FALLBACK_REASONS = ("sparse", "ragged", "off_ladder", "signature", "specless")

    @staticmethod
    def fallback_reason(tier: str, reason: str) -> str:
        """``ml.<tier>.fastpath.fallback.<reason>`` — why a batch left the
        plan; ``tier`` is ``serving`` or ``batch``."""
        return f"ml.{tier}.fastpath.fallback.{reason}"


class Histogram:
    """Bounded-window observation histogram: keeps the last ``window``
    observations and answers nearest-rank quantiles over them. Thread-safe."""

    def __init__(self, window: int = 4096):
        self._window = int(window)
        self._values: List[float] = []
        self._pos = 0
        self._count = 0
        self._lock = threading.Lock()

    @property
    def count(self) -> int:
        """Observations made since creation (the window keeps the last ones)."""
        with self._lock:
            return self._count

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._count += 1
            if len(self._values) < self._window:
                self._values.append(value)
            else:  # ring overwrite: oldest observation drops out
                self._values[self._pos] = value
                self._pos = (self._pos + 1) % self._window

    def quantiles(self, qs: Sequence[float]) -> List[Optional[float]]:
        """Nearest-rank quantiles with one sort for the whole batch."""
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if not self._values:
                return [None for _ in qs]
            ordered = sorted(self._values)
        n = len(ordered)
        return [ordered[min(int(q * n), n - 1)] for q in qs]


class MetricsRegistry:
    """Named gauges per scope."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gauges: Dict[str, Dict[str, Any]] = {}

    def gauge(self, scope: str, name: str, value: Any) -> None:
        with self._lock:
            self._gauges.setdefault(scope, {})[name] = value

    def counter(self, scope: str, name: str, inc: int = 1) -> int:
        """Increment-and-get a monotonically growing gauge."""
        with self._lock:
            group = self._gauges.setdefault(scope, {})
            group[name] = int(group.get(name, 0)) + inc
            return group[name]

    def histogram(self, scope: str, name: str, window: int = 4096) -> Histogram:
        """Get-or-create the named Histogram (the stored value IS the Histogram)."""
        with self._lock:
            group = self._gauges.setdefault(scope, {})
            hist = group.get(name)
            if not isinstance(hist, Histogram):
                hist = Histogram(window)
                group[name] = hist
            return hist

    def observe(self, scope: str, name: str, value: float) -> None:
        self.histogram(scope, name).observe(value)

    def get(self, scope: str, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._gauges.get(scope, {}).get(name, default)


metrics = MetricsRegistry()
