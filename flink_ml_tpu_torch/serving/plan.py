"""CompiledServingPlan — the serving fast path: per-key chains over
device-resident model tensors, warmed before a version serves, with one
readback per batch.

Twin of ``flink_ml_tpu/serving/plan.py`` for the unsharded path. The chain
machinery is ``servable/planner.py``; this module adds the serving policy:

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
  ``ml.serving.fastpath.fallback.batches`` and the per-reason counter.

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
                 sparse: Optional[Dict[str, int]] = None):
        self.segments = segments
        self.scope = scope
        self.device = device
        self.fusion = fusion
        #: The sparse hints the segments were built under (None = the
        #: convention is off) — part of the server's rebuild key.
        self.sparse_hints = sparse
        self._on_plan = plan_recorder(scope)
        n_fused = sum(len(s.specs) for s in segments if isinstance(s, FusedSegment))
        n_fallback = sum(1 for s in segments if isinstance(s, FallbackStage))
        metrics.gauge(scope, MLMetrics.SERVING_FUSED_STAGES, n_fused)
        metrics.gauge(scope, MLMetrics.SERVING_FALLBACK_STAGES, n_fallback)
        metrics.gauge(scope, MLMetrics.FUSION_MODE, 1 if fusion.fast else 0)

    @staticmethod
    def build(
        servable,
        *,
        scope: str = "ml.serving[plan]",
        fusion: Optional[Any] = None,
        device=None,
        sparse: Optional[Dict[str, int]] = None,
    ) -> Optional["CompiledServingPlan"]:
        """Group the servable's consecutive kernel-spec stages into segments
        and move their model arrays to ``device`` (``None`` → the GPU; no
        card raises ``RuntimeError``). ``fusion`` is the resolved
        :class:`~flink_ml_tpu_torch.servable.fusion.FusionTier`, default the
        ``fusion.mode`` config. ``sparse`` is the ``{column: dim}`` of inputs
        known to arrive sparse (``servable.sparse.resolve_sparse_hints`` of
        the warmup template), or None with the convention off. Raises
        whatever ``kernel_spec()`` raises."""
        device = resolve_device(device)
        stages = (
            list(servable.servables)
            if isinstance(servable, PipelineModelServable)
            else [servable]
        )
        if fusion is None:
            fusion = resolve_fusion_tier()
        segments = build_segments(stages, device, fusion, sparse)
        if not any(isinstance(s, FusedSegment) for s in segments):
            return None
        return CompiledServingPlan(segments, scope, device, fusion, sparse)

    # -- warmup ---------------------------------------------------------------
    def warmup(self, template: DataFrame, buckets: Sequence[int]) -> None:
        """Build every (segment, bucket[, nnz cap]) chain and run it once —
        and every fallback stage once per bucket — on the caller's thread,
        before the version flip. Sparse segments warm every cap of
        ``servable.sparse.resolve_warm_caps()``, packing the template at each
        rung (rows longer than a rung are clipped: the results are
        discarded)."""
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
    ) -> Tuple[Dict[str, Any], Hashable]:
        """One host-side gather of the segment's input columns, checked
        against the key's recorded signature, then moved to the device.
        Returns ``(device inputs, key)``: the key is the padded bucket, or
        ``(bucket, cap)`` when the segment has sparse inputs — all
        its sparse columns padded to the widest rung among them, so a batch
        has one cap. ``cap`` forces the rung (warmup walks the ladder;
        ``warm`` clips rows a small rung cannot hold)."""
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
        return {name: to_device(arr, self.device) for name, arr in arrays.items()}, key

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
