"""Runtime configuration tier — the ``serving.*``, ``fusion.*``,
``sparse.*`` and ``batch.*`` options the plan tiers read, the ``train.*`` and
``mesh.*`` options the trainer reads, and the ``datacache.*`` / ``native.datacache.enabled``
options of the host-tier training cache.

Twin of ``flink_ml_tpu/config.py``: the option keys, defaults and the
environment-variable names derived from them (``serving.max.batch.size`` →
``FLINK_ML_TPU_SERVING_MAX_BATCH_SIZE``) are identical, so one deployment's
settings configure both packages. Resolution order per option: programmatic
``set()`` > environment variable > default.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict

__all__ = ["ConfigOption", "Configuration", "Options", "config", "resolve_cache_config"]


class ConfigOption:
    """A typed runtime option."""

    def __init__(self, key: str, type_: Callable, default, description: str):
        self.key = key
        self.type = type_
        self.default = default
        self.description = description

    @property
    def env_var(self) -> str:
        return "FLINK_ML_TPU_" + self.key.upper().replace(".", "_").replace("-", "_")

    def __repr__(self) -> str:
        return f"ConfigOption({self.key!r}, default={self.default!r})"


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("1", "true", "yes", "on")


class Options:
    """The runtime options of the serving path."""

    SERVING_MAX_BATCH_SIZE = ConfigOption(
        "serving.max.batch.size",
        int,
        64,
        "Largest micro-batch (rows) the serving batcher coalesces — also the "
        "largest padded bucket, so it bounds the set of chains built per version.",
    )
    SERVING_MAX_DELAY_MS = ConfigOption(
        "serving.max.delay.ms",
        float,
        2.0,
        "How long the micro-batcher may hold the first queued request while "
        "coalescing more (the batching-latency budget).",
    )
    SERVING_QUEUE_CAPACITY_ROWS = ConfigOption(
        "serving.queue.capacity.rows",
        int,
        1024,
        "Admission-control bound: rows that may wait in the serving queue "
        "before new requests are rejected with ServingOverloadedError.",
    )
    SERVING_DEFAULT_TIMEOUT_MS = ConfigOption(
        "serving.default.timeout.ms",
        float,
        10_000.0,
        "Per-request deadline when the caller does not pass one; a request "
        "not completed by its deadline raises ServingDeadlineError.",
    )
    SERVING_POLL_INTERVAL_MS = ConfigOption(
        "serving.poll.interval.ms",
        float,
        1000.0,
        "How often ModelVersionPoller re-scans the model directory for a "
        "newer published version.",
    )
    SERVING_POLL_BACKOFF_MAX_MS = ConfigOption(
        "serving.poll.backoff.max.ms",
        float,
        30_000.0,
        "Ceiling of the ModelVersionPoller's jittered exponential backoff on "
        "consecutive scan failures; one successful scan resets the wait to "
        "serving.poll.interval.ms.",
    )
    SERVING_FASTPATH = ConfigOption(
        "serving.fastpath",
        _parse_bool,
        True,
        "Serve through CompiledServingPlan when the servable exposes kernel "
        "specs: per-bucket chains with device-resident model arrays. Off = "
        "always the per-stage transform path.",
    )
    SERVING_PIPELINE_DEPTH = ConfigOption(
        "serving.pipeline.depth",
        int,
        2,
        "Micro-batcher dispatch window: how many batches may be dispatched to "
        "the device before the oldest is finalized. 2 overlaps host-side "
        "claim/pad of batch N+1 with device execution of batch N; 1 = strict "
        "sequential. Only effective on the fast path.",
    )
    FUSION_MODE = ConfigOption(
        "fusion.mode",
        str,
        "exact",
        "Fusion tier of the compiled plans. 'exact' (default) = per-stage "
        "programs with elementwise-only merges. 'fast' = merge across "
        "reduction boundaries and, for chains the cost model marks hottest, "
        "run the hand-written CUDA megakernel; results carry a per-chain ulp "
        "envelope instead of bit-equality.",
    )
    FUSION_MEGAKERNEL = ConfigOption(
        "fusion.megakernel",
        _parse_bool,
        True,
        "Whether fusion.mode=fast may run the megakernel for hot chains. Off = "
        "fast mode still merges across reductions but only into plain "
        "PyTorch programs. No effect in exact mode.",
    )
    FUSION_MEGAKERNEL_MIN_SCORE = ConfigOption(
        "fusion.megakernel.min.score",
        float,
        1e6,
        "Cost-model hotness bar for the megakernel: a chain runs as the "
        "megakernel only when rows x estimated-FLOPs-per-row (from stage "
        "shapes) reaches this score for the key being built.",
    )
    SPARSE_FASTPATH = ConfigOption(
        "sparse.fastpath",
        _parse_bool,
        True,
        "Let SparseVector columns ride the compiled plans through the sparse "
        "calling convention (servable/sparse.py): values/ids/nnz as dense "
        "device tensors on the power-of-two nnz-cap ladder. Off = every "
        "sparse column falls back to the per-stage path.",
    )
    SPARSE_NNZ_CAP_MAX = ConfigOption(
        "sparse.nnz.cap.max",
        int,
        64,
        "Top rung of the sparse nnz-per-row bucket ladder. A batch whose "
        "rows carry more entries than this is off-ladder and serves through "
        "the per-stage fallback (counted under the 'off_ladder' fallback "
        "reason) instead of building an unbounded chain set.",
    )
    SPARSE_WARMUP_CAPS = ConfigOption(
        "sparse.warmup.caps",
        str,
        None,
        "Comma-separated nnz caps the serving warmup builds per bucket for "
        "sparse segments (each rounds up to its ladder rung). Default: the "
        "full power-of-two ladder up to sparse.nnz.cap.max.",
    )

    BATCH_FASTPATH = ConfigOption(
        "batch.fastpath",
        _parse_bool,
        True,
        "Run PipelineModel.transform through CompiledBatchPlan when stages "
        "expose kernel specs: chains of device programs with columns "
        "device-resident between stages, streamed in chunks. Off = always the "
        "per-stage transform path.",
    )
    BATCH_CHUNK_ROWS = ConfigOption(
        "batch.chunk.rows",
        int,
        65_536,
        "Rows per device chunk of the batch transform fast path: inputs larger "
        "than one chunk stream through the plan chunk by chunk (one upload and "
        "one readback each).",
    )
    BATCH_PREFETCH_DEPTH = ConfigOption(
        "batch.prefetch.depth",
        int,
        2,
        "Chunks that may be dispatched to the device before the oldest is read "
        "back. 2 overlaps the host gather and upload of chunk j+1 with the "
        "device work of chunk j; 1 = strictly one chunk at a time.",
    )
    SERVING_MESH = ConfigOption(
        "serving.mesh",
        int,
        1,
        "Data-parallel mesh width of the serving fast path: a bucket's rows "
        "split into N shards, the chain run once per shard on the plan's "
        "shard grid (servable/sharding.py), model arrays placed at swap time. "
        "1 (default) = the single-device path. Buckets become multiples of "
        "MIN_SHARD_ROWS * N so per-row results stay bit-identical to mesh=1.",
    )
    SERVING_MESH_MODEL = ConfigOption(
        "serving.mesh.model",
        int,
        1,
        "Tensor-parallel axis of the serving mesh: wide 2-D model arrays (the "
        "MLP's W{i}, KMeans' centroids) split their output dimension over this "
        "many shards. Not bit-exact — results carry an envelope of mesh 1 "
        "(rtol 1e-5, atol 1e-6). 1 (default) = no tensor parallelism.",
    )
    BATCH_MESH = ConfigOption(
        "batch.mesh",
        int,
        1,
        "Data-parallel mesh width of the batch transform fast path: each chunk's "
        "rows split over N shards. Ragged final chunks round up to a multiple of "
        "MIN_SHARD_ROWS * N (pad rows sliced off, counted by "
        "ml.batch.shard.pad.rows); other tails run replicated so per-row results "
        "stay bit-identical to mesh=1. 1 = the single-device path.",
    )
    BATCH_MESH_MODEL = ConfigOption(
        "batch.mesh.model",
        int,
        1,
        "Tensor-parallel axis of the batch transform mesh — the same split and "
        "envelope as serving.mesh.model. 1 = off.",
    )
    MESH_DATA_AXIS_SIZE = ConfigOption(
        "mesh.data.axis.size",
        int,
        None,
        "Data-parallel axis size of the default training mesh "
        "(parallel/mesh.py MeshContext). Default: the world size / model axis size.",
    )
    MESH_MODEL_AXIS_SIZE = ConfigOption(
        "mesh.model.axis.size",
        int,
        1,
        "Model-parallel axis size of the default training mesh.",
    )

    DATACACHE_SPILL_DIR = ConfigOption(
        "datacache.spill.dir",
        str,
        None,
        "Base path for capacity-tier cache spill files "
        "(ref iteration.data-cache.path). Default: none — past-budget chunks "
        "stay in host RAM unless a spill dir is configured.",
    )
    DATACACHE_MEMORY_BUDGET_BYTES = ConfigOption(
        "datacache.memory.budget.bytes",
        int,
        1 << 30,
        "Host RAM a capacity-tier cache may hold before spilling to disk "
        "(the managed-memory fraction role of the reference's MemorySegment pool).",
    )
    TRAIN_STREAM_WINDOW_ROWS = ConfigOption(
        "train.stream.window.rows",
        int,
        65_536,
        "Per-shard device window size (rows) for streamed training out of a "
        "host-tier cache larger than the card's memory.",
    )
    NATIVE_DATACACHE_ENABLED = ConfigOption(
        "native.datacache.enabled",
        _parse_bool,
        True,
        "Whether create_capacity_cache may use the C++ chunk store "
        "(native/datacache.cpp, built with the host compiler) when it builds.",
    )

    TRAIN_MESH = ConfigOption(
        "train.mesh",
        int,
        None,
        "Data-axis width of the sharded training mesh (parallel/train_sharding.py): "
        "the world size of the torch.distributed process group the fit runs on. "
        "Unset: single-device training. Set, including 1: SGD and KMeans run the "
        "deterministic sharded tier (block-cyclic deal, mapreduce collectives, "
        "fits bit-identical across widths); the sparse and MLP fits all-reduce.",
    )
    TRAIN_MESH_MODEL = ConfigOption(
        "train.mesh.model",
        int,
        1,
        "Model-axis width of the sharded training mesh (tensor parallelism for wide "
        "coefficients): the fit runs on train.mesh × train.mesh.model ranks and rides "
        "the all-reduce paths, outside the deterministic tier.",
    )
    TRAIN_MESH_HOSTS = ConfigOption(
        "train.mesh.hosts",
        int,
        1,
        "Host count of a multi-host training run. >1 requires torchrun's "
        "environment, from which the one init_process_group call is made.",
    )

    @classmethod
    def all(cls) -> Dict[str, ConfigOption]:
        return {v.key: v for v in vars(cls).values() if isinstance(v, ConfigOption)}


class Configuration:
    """Resolved option values: set() > environment > default."""

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def set(self, option: ConfigOption, value) -> "Configuration":
        if value is None:  # setting None means "no override" — same as unset
            return self.unset(option)
        with self._lock:
            self._values[option.key] = option.type(value)
        return self

    def unset(self, option: ConfigOption) -> "Configuration":
        with self._lock:
            self._values.pop(option.key, None)
        return self

    def get(self, option: ConfigOption):
        with self._lock:
            if option.key in self._values:
                return self._values[option.key]
        env = os.environ.get(option.env_var)
        if env is not None:
            return option.type(env)
        return option.default


config = Configuration()


def resolve_cache_config(memory_budget_bytes, spill_dir):
    """Capacity-cache construction arguments resolved against the config
    tier: an argument given wins, else ``datacache.memory.budget.bytes`` and
    ``datacache.spill.dir`` decide."""
    if memory_budget_bytes is None:
        memory_budget_bytes = config.get(Options.DATACACHE_MEMORY_BUDGET_BYTES)
    if spill_dir is None:
        spill_dir = config.get(Options.DATACACHE_SPILL_DIR)
    return memory_budget_bytes, spill_dir
