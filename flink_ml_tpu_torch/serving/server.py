"""InferenceServer — the online serving front end (twin of
``flink_ml_tpu/serving/server.py``).

Wraps a servable (or a whole ``PipelineModelServable``) behind a dynamic
micro-batcher (``batcher.py``), a versioned registry with atomic hot swap
and an optional directory poller (``registry.py``), admission control and
the ``ml.serving.*`` metrics under scope ``ml.serving[<name>]``. On the
fast path every version is served by a
:class:`~flink_ml_tpu_torch.serving.plan.CompiledServingPlan` built and
warmed on the swapping thread before the version flips.

The server runs on the GPU unless it is given ``device="cpu"``; without a
card the default raises at construction. With ``serving.mesh`` or
``serving.mesh.model`` above 1 (``ServingConfig(mesh=, mesh_model=)``) every
version's plan runs on one shard grid resolved at construction
(``servable/sharding.py``), and the batcher pads to its mesh bucket ladder.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.metrics import MLMetrics
from flink_ml_tpu_torch.servable.fusion import resolve_fusion_tier
from flink_ml_tpu_torch.servable.sharding import resolve_plan_sharding
from flink_ml_tpu_torch.servable.sparse import resolve_sparse_hints
from flink_ml_tpu_torch.serving.batcher import MicroBatcher, pad_to
from flink_ml_tpu_torch.serving.errors import ServingClosedError
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan
from flink_ml_tpu_torch.serving.registry import ModelRegistry, ModelVersionPoller

__all__ = ["ServingConfig", "ServingResponse", "InferenceServer"]

#: "plan not built yet" marker distinct from "built, and it is None".
_PLAN_UNSET = object()


class _DispatchHandle:
    """A dispatched batch: the plan's in-flight execution plus the model
    version snapshotted at dispatch time."""

    __slots__ = ("_execution", "_version")

    def __init__(self, execution, version: int):
        self._execution = execution
        self._version = version

    def result(self) -> Tuple[DataFrame, int]:
        return self._execution.finalize(), self._version


class ServingConfig:
    """Resolved serving knobs; every unset field falls back to the runtime
    config tier (``flink_ml_tpu_torch.config``)."""

    def __init__(
        self,
        max_batch_size: Optional[int] = None,
        max_delay_ms: Optional[float] = None,
        queue_capacity_rows: Optional[int] = None,
        default_timeout_ms: Optional[float] = None,
        fastpath: Optional[bool] = None,
        pipeline_depth: Optional[int] = None,
        fusion_mode: Optional[str] = None,
        poll_interval_ms: Optional[float] = None,
        mesh: Optional[int] = None,
        mesh_model: Optional[int] = None,
    ):
        def pick(value, cast, option):
            return cast(value) if value is not None else config.get(option)

        self.max_batch_size = pick(max_batch_size, int, Options.SERVING_MAX_BATCH_SIZE)
        self.max_delay_ms = pick(max_delay_ms, float, Options.SERVING_MAX_DELAY_MS)
        self.queue_capacity_rows = pick(queue_capacity_rows, int, Options.SERVING_QUEUE_CAPACITY_ROWS)
        self.default_timeout_ms = pick(default_timeout_ms, float, Options.SERVING_DEFAULT_TIMEOUT_MS)
        self.fastpath = pick(fastpath, bool, Options.SERVING_FASTPATH)
        self.pipeline_depth = pick(pipeline_depth, int, Options.SERVING_PIPELINE_DEPTH)
        self.fusion_mode = pick(fusion_mode, str, Options.FUSION_MODE)
        self.poll_interval_ms = pick(poll_interval_ms, float, Options.SERVING_POLL_INTERVAL_MS)
        self.mesh = pick(mesh, int, Options.SERVING_MESH)
        self.mesh_model = pick(mesh_model, int, Options.SERVING_MESH_MODEL)

    def __repr__(self) -> str:
        return (
            f"ServingConfig(max_batch_size={self.max_batch_size}, "
            f"max_delay_ms={self.max_delay_ms}, "
            f"queue_capacity_rows={self.queue_capacity_rows}, "
            f"default_timeout_ms={self.default_timeout_ms}, "
            f"fastpath={self.fastpath}, pipeline_depth={self.pipeline_depth}, "
            f"fusion_mode={self.fusion_mode}, poll_interval_ms={self.poll_interval_ms}, "
            f"mesh={self.mesh}, mesh_model={self.mesh_model})"
        )


class ServingResponse:
    """One request's result: the transformed rows, the model version that
    served them, the enqueue→response latency and the padded ``bucket`` the
    batch ran at."""

    __slots__ = ("dataframe", "model_version", "latency_ms", "bucket")

    def __init__(self, dataframe: DataFrame, model_version: int, latency_ms: float, bucket: int):
        self.dataframe = dataframe
        self.model_version = model_version
        self.latency_ms = latency_ms
        self.bucket = bucket

    def __repr__(self) -> str:
        return (
            f"ServingResponse(rows={len(self.dataframe)}, "
            f"model_version={self.model_version}, latency_ms={self.latency_ms:.2f}, "
            f"bucket={self.bucket})"
        )


def _placement(device, sharding):
    """A plan's placement: its shard grid's shape and devices (a sharded
    plan's own device is its first data shard's), or its one device."""
    return (sharding.key, sharding.devices) if sharding is not None else device


class InferenceServer:
    """Concurrent, versioned, micro-batched serving for one servable slot.

    >>> server = InferenceServer(servable, name="ctr")      # on the GPU
    >>> out = server.predict(one_row_df)                     # blocks; batched underneath
    >>> out.dataframe["prediction"], out.model_version
    """

    def __init__(
        self,
        servable=None,
        *,
        version: int = 1,
        name: str = "default",
        serving_config: Optional[ServingConfig] = None,
        warmup_template: Optional[DataFrame] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.name = name
        self.scope = f"{MLMetrics.SERVING_GROUP}[{name}]"
        self.config = serving_config or ServingConfig()
        self.registry = ModelRegistry(self.scope)
        self._warmup_template = warmup_template
        self._template_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._closed = False
        self._poller: Optional[ModelVersionPoller] = None
        # Resolved once: every version's plan is built under it, and a plan a
        # servable carries from elsewhere rebuilds on key mismatch.
        self._fusion = resolve_fusion_tier(self.config.fusion_mode) if self.config.fastpath else None
        # The shard grid, resolved once like the fusion tier: every version's
        # plan is built on it (weights placed at swap time), and a ladder the
        # mesh cannot take fails here, at construction.
        self._sharding = (
            resolve_plan_sharding(self.config.mesh, self.config.mesh_model, self.device)
            if self.config.fastpath else None
        )
        self._batcher = MicroBatcher(
            self._execute,
            max_batch_size=self.config.max_batch_size,
            max_delay_ms=self.config.max_delay_ms,
            queue_capacity_rows=self.config.queue_capacity_rows,
            scope=self.scope,
            response_factory=ServingResponse,
            dispatch=self._dispatch if self.config.fastpath else None,
            pipeline_depth=self.config.pipeline_depth,
            buckets=(self._sharding.serving_buckets(self.config.max_batch_size)
                     if self._sharding is not None else None),
        )
        if servable is not None:
            self.swap(version, servable)

    # -- the one place a batch meets a model ----------------------------------
    def _plan_stale(self, plan, sparse_hints) -> bool:
        """Whether a cached plan was built for another device, shard grid,
        fusion tier or sparseness than this server's: it then holds the wrong
        model tensors or program partition and must rebuild."""
        return plan is not None and (
            _placement(plan.device, plan.sharding) != _placement(self.device, self._sharding)
            or plan.fusion.key != self._fusion.key
            or plan.sparse_hints != sparse_hints
        )

    def _plan_for(self, servable) -> Optional[CompiledServingPlan]:
        """The servable's plan, cached on it; rebuilt when stale. Its sparse
        hints come from the warmup template: columns the template shows
        sparse build sparse-convention segments. Normally built by ``warmup``
        off the serving path; a server that never saw a template builds on
        the first batch instead."""
        if not self.config.fastpath:
            return None
        with self._template_lock:
            template = self._warmup_template
        sparse_hints = resolve_sparse_hints(template)
        plan = getattr(servable, "_fastpath_plan", _PLAN_UNSET)
        if plan is _PLAN_UNSET or self._plan_stale(plan, sparse_hints):
            plan = CompiledServingPlan.build(
                servable, scope=self.scope, fusion=self._fusion, device=self.device,
                sparse=sparse_hints, sharding=self._sharding,
            )
            servable._fastpath_plan = plan
        return plan

    def _execute(self, padded_df: DataFrame) -> Tuple[DataFrame, int]:
        version, servable = self.registry.current()  # one snapshot per batch
        plan = self._plan_for(servable)
        if plan is not None:
            return plan.execute(padded_df), version
        return servable.transform(padded_df, device=self.device), version

    def _dispatch(self, padded_df: DataFrame):
        """Async seam of the batcher's window: a handle whose ``result()`` is
        the one blocking readback, or None to serve synchronously."""
        version, servable = self.registry.current()  # one snapshot per batch
        plan = self._plan_for(servable)
        if plan is None:
            return None
        return _DispatchHandle(plan.dispatch(padded_df), version)

    # -- client API ------------------------------------------------------------
    def predict(self, df: DataFrame, timeout_ms: Optional[float] = None) -> ServingResponse:
        """Serve ``df`` (1..max_batch_size rows), blocking until the response.
        Raises ``ServingOverloadedError`` (queue full), ``ServingDeadlineError``,
        ``ServingClosedError`` or, through the batch, ``NoModelError``."""
        return self.submit(df, timeout_ms).result()

    def submit(self, df: DataFrame, timeout_ms: Optional[float] = None):
        """Async variant of ``predict``: returns a handle with ``.result()``."""
        with self._state_lock:
            if self._closed:
                raise ServingClosedError("server is closed")
        with self._template_lock:
            # The first request doubles as the warmup template for later swaps.
            if self._warmup_template is None:
                self._warmup_template = df.take([0])
        timeout_s = (timeout_ms if timeout_ms is not None else self.config.default_timeout_ms) / 1000.0
        return self._batcher.submit(df, timeout_s)

    # -- model lifecycle -------------------------------------------------------
    def warmup(self, servable) -> None:
        """Build the servable's plan (model arrays to the device, or to every
        device of the shard grid) and run one template batch per bucket — per
        bucket and nnz cap for sparse segments, on every shard — on the
        caller's thread, so the serving path never builds a chain or uploads
        weights."""
        with self._template_lock:
            template = self._warmup_template
        plan = self._plan_for(servable)
        if template is None:
            return  # nothing seen yet: the first real batch builds lazily
        if plan is not None:
            plan.warmup(template, self._batcher.buckets)
        else:
            for bucket in self._batcher.buckets:
                servable.transform(pad_to(template, bucket), device=self.device)

    def swap(self, version: int, servable) -> None:
        """Warm then atomically install ``servable`` as ``version`` (which
        must advance)."""
        self.warmup(servable)
        self.registry.swap(version, servable)

    def rollback(self, version: int, servable) -> None:
        """Warm then atomically revert serving to an OLDER ``version``. The
        discipline of ``swap``: the restored version's plan is built and
        warmed on every shard on the caller's thread before the flip, so the
        rollback puts no build on the serving path."""
        self.warmup(servable)
        self.registry.swap(version, servable, allow_rollback=True)

    def attach_poller(self, directory: str, *, loader=None, interval_ms: Optional[float] = None,
                      start: bool = True) -> ModelVersionPoller:
        """Watch ``directory`` for published versions (``registry.publish_servable``)
        and hot-swap each in as it appears, warmed by this server's
        ``warmup`` before the flip. ``close()`` stops the poller."""
        poller = ModelVersionPoller(
            directory, self.registry, loader=loader, warmup=self.warmup,
            interval_ms=interval_ms if interval_ms is not None else self.config.poll_interval_ms,
        )
        with self._state_lock:
            if self._poller is not None:
                raise RuntimeError("a poller is already attached")
            self._poller = poller
        if start:
            poller.start()
        return poller

    @property
    def model_version(self) -> Optional[int]:
        return self.registry.version

    @property
    def executed_batch_sizes(self) -> List[Tuple[int, int]]:
        """(rows, bucket) per executed batch."""
        return list(self._batcher.executed_batch_sizes)

    # -- shutdown --------------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop the poller and the batcher. ``drain=True`` serves everything
        already queued first; ``drain=False`` fails queued requests with
        ``ServingClosedError``."""
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            poller = self._poller
        if poller is not None:
            poller.stop()  # joins the poll thread: outside the lock
        self._batcher.close(drain=drain)

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)
