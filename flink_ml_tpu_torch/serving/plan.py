"""CompiledServingPlan — the serving fast path: per-key chains over
device-resident model tensors, warmed before a version serves, with one
readback per batch.

Twin of ``flink_ml_tpu/serving/plan.py``. The chain machinery is
``servable/planner.py``; this module adds the serving policy:

- chains are keyed by the micro-batcher's padded bucket — and, for a segment
  with sparse inputs, by ``(bucket, nnz cap)``, the cap being the batch's
  rung on the nnz ladder shared by all its sparse columns — so their set is
  fixed and small;
- ``warmup`` builds every (segment, key) chain before the version flip, the
  whole configured cap ladder for sparse segments; a key it did not cover is
  built on the serving path and bumps ``ml.serving.fastpath.compiles`` — the
  alarm that warmup coverage is wrong;
- a batch the chain cannot take (a sparse column where the segment expects a
  dense one, rows above ``sparse.nnz.cap.max``, another width) runs that
  segment through the per-stage ``transform`` and bumps
  ``ml.serving.fastpath.fallback.batches`` and the per-reason counter;
- with a :class:`~flink_ml_tpu_torch.servable.sharding.PlanSharding`
  (``serving.mesh`` / ``serving.mesh.model`` above 1) the model tensors sit
  on the shard grid from build time, a bucket's rows go up as one tensor a
  data shard, the chain runs once per shard, and warmup runs every ladder
  bucket on every shard; a bucket off the mesh ladder (not a multiple of
  ``MIN_SHARD_ROWS · n_data``) cannot shard bit-exactly and falls back
  per-stage under the ``off_ladder`` reason.

``dispatch`` uploads the batch and launches the chain without waiting for the
device; the returned :class:`PlanExecution`'s ``finalize`` is the only place
results come back to the host.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.servable.builder import PipelineModelServable
from flink_ml_tpu_torch.servable.fusion import plan_recorder, resolve_fusion_tier
from flink_ml_tpu_torch.servable.kernel_spec import SPARSE_KINDS
from flink_ml_tpu_torch.servable.planner import (
    FallbackStage,
    FusedSegment,
    IneligibleBatch,
    PlanExecution,
    build_segments,
    run_segment,
    to_device,
)
from flink_ml_tpu_torch.servable.sparse import resolve_nnz_cap_max, resolve_warm_caps
from flink_ml_tpu_torch.serving.batcher import pad_to

__all__ = ["CompiledServingPlan", "PlanExecution", "chain_kinds"]


class CompiledServingPlan:
    """Compiled form of one servable (or ``PipelineModelServable``) on one
    device. Build via :meth:`build`; ``None`` means no stage has a kernel spec
    and the per-stage path should serve."""

    def __init__(self, segments: List[Any], scope: str, device, fusion,
                 sparse: Optional[Dict[str, int]] = None, sharding: Optional[Any] = None):
        self.segments = segments
        self.scope = scope
        self.device = device
        self.fusion = fusion
        #: The shard grid the segments were built on (None: one device) —
        #: part of the server's rebuild key.
        self.sharding = sharding
        #: The sparse hints the segments were built under (None = the
        #: convention is off) — part of the server's rebuild key.
        self.sparse_hints = sparse
        self._on_plan = plan_recorder(scope)
        n_fused = sum(len(s.specs) for s in segments if isinstance(s, FusedSegment))
        n_fallback = sum(1 for s in segments if isinstance(s, FallbackStage))
        metrics.gauge(scope, MLMetrics.SERVING_FUSED_STAGES, n_fused)
        metrics.gauge(scope, MLMetrics.SERVING_FALLBACK_STAGES, n_fallback)
        metrics.gauge(scope, MLMetrics.FUSION_MODE, 1 if fusion.fast else 0)
        if sharding is not None:
            metrics.gauge(scope, MLMetrics.SERVING_SHARD_COUNT, sharding.n_data)
            metrics.gauge(scope, MLMetrics.SERVING_SHARD_MODEL_AXIS, sharding.n_model)

    def __repr__(self) -> str:
        return (f"CompiledServingPlan(scope={self.scope!r}, device={self.device}, "
                f"fusion={self.fusion.mode!r}, sharding={self.sharding!r})")

    @staticmethod
    def build(
        servable,
        *,
        scope: str = "ml.serving[plan]",
        fusion: Optional[Any] = None,
        device=None,
        sparse: Optional[Dict[str, int]] = None,
        sharding: Optional[Any] = None,
    ) -> Optional["CompiledServingPlan"]:
        """Group the servable's consecutive kernel-spec stages into segments
        and move their model arrays to ``device`` (``None`` → the GPU; no
        card raises ``RuntimeError``), or onto ``sharding``'s shard grid —
        at warmup/swap time, never on the serving path. ``fusion`` is the resolved
        :class:`~flink_ml_tpu_torch.servable.fusion.FusionTier`, default the
        ``fusion.mode`` config. ``sparse`` is the ``{column: dim}`` of inputs
        known to arrive sparse (``servable.sparse.resolve_sparse_hints`` of
        the warmup template), or None with the convention off. Raises
        whatever ``kernel_spec()`` raises."""
        device = resolve_device(device) if sharding is None else sharding.data_devices[0]
        stages = (
            list(servable.servables)
            if isinstance(servable, PipelineModelServable)
            else [servable]
        )
        if fusion is None:
            fusion = resolve_fusion_tier()
        segments = build_segments(stages, device, fusion, sparse, sharding)
        if not any(isinstance(s, FusedSegment) for s in segments):
            return None
        return CompiledServingPlan(segments, scope, device, fusion, sparse, sharding)

    # -- warmup ---------------------------------------------------------------
    def warmup(self, template: DataFrame, buckets: Sequence[int]) -> None:
        """Build every (segment, bucket[, nnz cap]) chain and run it once —
        and every fallback stage once per bucket — on the caller's thread,
        before the version flip. Sparse segments warm every cap of
        ``servable.sparse.resolve_warm_caps()``, packing the template at each
        rung (rows longer than a rung are clipped: the results are
        discarded). On a shard grid each bucket's chain runs on every shard."""
        t0 = time.perf_counter()
        warm_caps: Tuple[Optional[int], ...] = (None,)
        if any(isinstance(s, FusedSegment) and s.has_sparse_inputs for s in self.segments):
            warm_caps = resolve_warm_caps()
        for bucket in buckets:
            for cap in warm_caps:
                df = pad_to(template, bucket)
                for segment in self.segments:
                    if isinstance(segment, FallbackStage):
                        df = segment.stage.transform(df, device=self.device)
                        continue
                    try:
                        inputs, key = self._ingest(
                            segment, df, bucket,
                            cap=cap if segment.has_sparse_inputs else None, warm=True,
                        )
                    except IneligibleBatch:
                        # The template itself cannot ride the chain (e.g. a
                        # sparse column where the segment is dense): traffic
                        # shaped like it serves per-stage.
                        for stage in segment.stages:
                            df = stage.transform(df, device=self.device)
                        continue
                    outputs = run_segment(segment, key, inputs, on_plan=self._on_plan)
                    df = PlanExecution(df, segment.pending(outputs)).finalize()
        metrics.gauge(
            self.scope, MLMetrics.SERVING_WARMUP_COMPILE_MS, (time.perf_counter() - t0) * 1000.0
        )

    # -- the hot path ---------------------------------------------------------
    def _ingest(
        self,
        segment: FusedSegment,
        df: DataFrame,
        bucket: int,
        cap: Optional[int] = None,
        warm: bool = False,
    ) -> Tuple[Any, Hashable]:
        """One host-side gather of the segment's input columns, checked
        against the key's recorded signature, then moved to the device.
        Returns ``(device inputs, key)``: the key is the padded bucket, or
        ``(bucket, cap)`` when the segment has sparse inputs — all
        its sparse columns padded to the widest rung among them, so a batch
        has one cap. ``cap`` forces the rung (warmup walks the ladder;
        ``warm`` clips rows a small rung cannot hold). On a shard grid the
        device inputs are one dict per data shard (``PlanSharding.put_columns``),
        and a bucket off the mesh ladder raises ``off_ladder``."""
        sharding = self.sharding
        if sharding is not None and bucket % sharding.row_multiple:
            # local shapes would gain remainder rows: only a caller that
            # bypasses the mesh ladder gets here, and it serves per-stage
            raise IneligibleBatch(
                f"bucket {bucket} not a multiple of the sharded bucket quantum "
                f"{sharding.row_multiple}",
                reason="off_ladder",
            )
        arrays: Dict[str, np.ndarray] = {}
        packed: List[Dict[str, np.ndarray]] = []
        shared_cap = cap or 0
        cap_max = resolve_nnz_cap_max()
        for name in segment.external_inputs:
            if segment.input_kind(name) in SPARSE_KINDS:
                triple, col_cap = segment.gather_sparse(
                    df, name, cap=cap, cap_max=cap_max, truncate=warm
                )
                packed.append(triple)
                shared_cap = max(shared_cap, col_cap)
            else:
                arrays[name] = segment.gather(df, name)
        for triple in packed:
            for pname, arr in triple.items():
                if arr.ndim == 2 and arr.shape[1] < shared_cap:
                    # extra id-0 / value-0 slots: identity terms of every fold
                    arr = np.pad(arr, ((0, 0), (0, shared_cap - arr.shape[1])))
                arrays[pname] = arr
        key: Hashable = (bucket, shared_cap) if packed else bucket
        signature = segment.signatures.get(key)
        if signature is not None:
            for name, arr in arrays.items():
                if tuple(arr.shape) != signature[name][0]:
                    raise IneligibleBatch(
                        f"column {name!r} shape {arr.shape} != built {signature[name][0]}",
                        reason="signature",
                    )
        if sharding is None:
            return {name: to_device(arr, self.device) for name, arr in arrays.items()}, key
        return sharding.put_columns(arrays), key

    def dispatch(self, padded_df: DataFrame) -> PlanExecution:
        """Run the plan on an already-padded batch. Fused segments launch
        their chain for the key on the committed model tensors; the trailing
        fused outputs stay on the device until ``finalize``."""
        bucket = len(padded_df)
        df = padded_df
        pending: List[Tuple[str, Any, Any, Any]] = []
        fused_ran = False
        for segment in self.segments:
            if isinstance(segment, FallbackStage):
                metrics.counter(self.scope, MLMetrics.fallback_reason("serving", "specless"))
                df = PlanExecution(df, pending).finalize()
                pending = []
                df = segment.stage.transform(df, device=self.device)
                continue
            try:
                inputs, key = self._ingest(segment, df, bucket)
            except IneligibleBatch as e:
                metrics.counter(self.scope, MLMetrics.SERVING_FALLBACK_BATCHES)
                metrics.counter(self.scope, MLMetrics.fallback_reason("serving", e.reason))
                df = PlanExecution(df, pending).finalize()
                pending = []
                for stage in segment.stages:
                    df = stage.transform(df, device=self.device)
                continue
            outputs = run_segment(
                segment,
                key,
                inputs,
                on_compile=lambda: metrics.counter(self.scope, MLMetrics.SERVING_FASTPATH_COMPILES),
                on_plan=self._on_plan,
            )
            pending = segment.pending(outputs)
            fused_ran = True
        if fused_ran:
            metrics.counter(self.scope, MLMetrics.SERVING_FUSED_BATCHES)
            if self.sharding is not None:
                metrics.counter(self.scope, MLMetrics.SERVING_SHARD_ROWS, bucket // self.sharding.n_data)
        return PlanExecution(df, pending)

    def execute(self, padded_df: DataFrame) -> DataFrame:
        """Synchronous convenience: dispatch + finalize."""
        return self.dispatch(padded_df).finalize()


def chain_kinds(plan: CompiledServingPlan) -> Dict[Hashable, Tuple[str, ...]]:
    """Key → program kinds chosen for it, over the plan's fused segments (the
    per-key plan choice, for tests and reports). A key is the bucket, or
    ``(bucket, nnz cap)`` for a segment with sparse inputs."""
    kinds: Dict[Hashable, Tuple[str, ...]] = {}
    for segment in plan.segments:
        if isinstance(segment, FusedSegment):
            for key, k in segment.plan_kinds.items():
                kinds[key] = kinds.get(key, ()) + k
    return kinds
