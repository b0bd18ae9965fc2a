"""CompiledBatchPlan — the batch transform fast path.

Twin of ``flink_ml_tpu/builder/batch_plan.py``, in float32, on one device or
on a plan's shard grid.
``PipelineModel.transform`` per stage reads every column to the device and
back for each stage; for chains of kernel-spec stages the plan instead runs
the serving tier's chain compiler (``servable/planner.py``) over offline
data:

- **Fusion**: consecutive stages exposing a
  :class:`~flink_ml_tpu_torch.servable.kernel_spec.KernelSpec` form a
  :class:`~flink_ml_tpu_torch.servable.planner.FusedSegment`, run as a chain
  of programs whose columns stay on the device between stages: one upload
  and one readback per chunk. In the exact tier (``fusion.mode=exact``) the
  chain is bit-identical to the per-stage path; in the fast tier a hot run
  with a hand-written megakernel runs as that kernel, inside the fast
  tier's envelope.
- **Chunked ingest with a prefetch window**: inputs longer than
  ``batch.chunk.rows`` stream through the chain in chunks. On a CUDA device
  each chunk's columns are staged in pinned host memory and copied with
  ``non_blocking=True`` on a side stream; the compute stream waits on the
  copy's event, so the upload of chunk j+1 overlaps the kernels of chunk j.
  Outputs come back the same way: a ``non_blocking`` copy into pinned host
  buffers on the compute stream, and an event the readback waits on. At most
  ``batch.prefetch.depth`` chunks are dispatched and not yet read back, so
  device and pinned memory stay bounded whatever the input's size.
- **Chain-boundary fallback**: a stage without a spec runs its ordinary
  ``transform`` on the whole DataFrame at the segment boundary; a column a
  chain cannot take (a sparse column where a dense kind is expected, a
  ragged column, rows past ``sparse.nnz.cap.max``) makes the whole segment
  run per stage for that call, counted by reason.

Programs are keyed by the ingest signature itself (chunk rows × column
shapes and dtypes) and built on first sight: a batch tier has no warmup.
``ml.batch.fastpath.compiles`` counts the signatures seen.

**Mesh sharding** (``batch.mesh`` / ``batch.mesh.model`` above 1,
``servable/sharding.py``): each chunk's rows go up through
``PlanSharding.put_batch``, one copy per data shard, and the chain runs once
per shard. A ragged final chunk whose rows are a multiple of
``MIN_SHARD_ROWS`` rounds up to a multiple of ``MIN_SHARD_ROWS · n_data``
(pad rows repeat row 0 and are sliced off at readback, counted by
``ml.batch.shard.pad.rows``); any other tail runs **replicated**, once on
each distinct device at its natural shape, read back from the first — so
per-row results stay bit-identical to the single-device path either way.

The JAX package's persistent plan cache and precision tiers are not ported
(ROADMAP Queue A 10).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.servable.fusion import plan_recorder, resolve_fusion_tier
from flink_ml_tpu_torch.servable.kernel_spec import SPARSE_KINDS
from flink_ml_tpu_torch.servable.sharding import resolve_plan_sharding
from flink_ml_tpu_torch.servable.planner import (
    FallbackStage,
    FusedSegment,
    IneligibleBatch,
    build_segments,
    run_segment,
    to_device,
)
from flink_ml_tpu_torch.servable.sparse import (
    SPARSE_MARK,
    rebuild_sparse_column,
    resolve_nnz_cap_max,
)

__all__ = ["BatchPlanInapplicable", "CompiledBatchPlan"]


class BatchPlanInapplicable(Exception):
    """The plan met a pipeline shape it cannot chain (a fallback stage
    returned multiple DataFrames): the caller reruns the per-stage path."""


class CompiledBatchPlan:
    """Compiled form of a PipelineModel's stage chain for offline data.
    Build via :meth:`build`; ``None`` means no stage has a kernel spec and
    the per-stage path should run."""

    def __init__(self, segments: List[Any], scope: str, device: torch.device, fusion: Any,
                 sharding: Optional[Any] = None):
        self.segments = segments
        self.scope = scope
        self.device = device
        self.fusion = fusion
        self.sharding = sharding
        self._on_plan = plan_recorder(scope)
        n_fused = sum(len(s.specs) for s in segments if isinstance(s, FusedSegment))
        n_fallback = sum(1 for s in segments if isinstance(s, FallbackStage))
        metrics.gauge(scope, MLMetrics.BATCH_FUSED_STAGES, n_fused)
        metrics.gauge(scope, MLMetrics.BATCH_FALLBACK_STAGES, n_fallback)
        metrics.gauge(scope, MLMetrics.FUSION_MODE, 1 if fusion.fast else 0)
        if sharding is not None:
            metrics.gauge(scope, MLMetrics.BATCH_SHARD_COUNT, sharding.n_data)

    def __repr__(self) -> str:
        return (f"CompiledBatchPlan(scope={self.scope!r}, device={self.device}, "
                f"fusion={self.fusion.mode!r}, sharding={self.sharding!r})")

    # -- construction ---------------------------------------------------------
    @staticmethod
    def build(
        stages: Sequence[Any],
        *,
        scope: str = "ml.batch[plan]",
        device=None,
        fusion: Optional[Any] = None,
        sparse: Optional[Dict[str, int]] = None,
        sharding: Optional[Any] = None,
    ) -> Optional["CompiledBatchPlan"]:
        """Group consecutive kernel-spec stages into fused segments and move
        their model arrays to ``device`` (None → the GPU; no card raises
        ``RuntimeError``), or onto ``sharding``'s shard grid — by default the
        ``batch.mesh`` / ``batch.mesh.model`` config (1 × 1: one device).
        Raises whatever ``kernel_spec()`` raises: an unloaded model fails
        here as its ``transform`` would. ``fusion`` defaults to the
        ``fusion.mode`` config, ``sparse`` is the ``{column: dim}`` of inputs
        known to arrive sparse (None: the convention is off). Publishes
        ``ml.batch.fastpath.plan.build.ms``."""
        t0 = time.perf_counter()
        if sharding is None:
            device = resolve_device(device)
            sharding = resolve_plan_sharding(
                config.get(Options.BATCH_MESH), config.get(Options.BATCH_MESH_MODEL), device
            )
        if sharding is not None:
            device = sharding.data_devices[0]
        if fusion is None:
            fusion = resolve_fusion_tier()
        segments = build_segments(stages, device, fusion, sparse, sharding)
        if not any(isinstance(s, FusedSegment) for s in segments):
            return None
        plan = CompiledBatchPlan(segments, scope, device, fusion, sharding)
        metrics.gauge(scope, MLMetrics.BATCH_PLAN_BUILD_MS, (time.perf_counter() - t0) * 1000.0)
        return plan

    # -- execution ------------------------------------------------------------
    def transform(self, df: DataFrame) -> DataFrame:
        """Run the chain: fused segments stream chunk-wise with the prefetch
        window; spec-less stages run their ordinary ``transform`` on the
        whole DataFrame at the chain boundary."""
        for segment in self.segments:
            if isinstance(segment, FallbackStage):
                metrics.counter(self.scope, MLMetrics.fallback_reason("batch", "specless"))
                out = segment.stage.transform(df, device=self.device)
                if isinstance(out, (list, tuple)):
                    if len(out) != 1:
                        raise BatchPlanInapplicable(
                            f"stage {type(segment.stage).__name__} returned {len(out)} outputs"
                        )
                    out = out[0]
                df = out
                continue
            df = self._run_fused(segment, df)
        return df

    def _gather(self, segment: FusedSegment, df: DataFrame) -> Dict[str, np.ndarray]:
        """One host-side read of every external input of the segment for the
        whole call: dense columns as float32, sparse and entries ones packed
        once at their ladder cap (the [n, K] / [n] arrays then slice per
        chunk like dense columns). Raises :class:`IneligibleBatch`."""
        full: Dict[str, np.ndarray] = {}
        cap_max = resolve_nnz_cap_max()
        for name in segment.external_inputs:
            if segment.input_kind(name) in SPARSE_KINDS:
                arrays, _cap = segment.gather_sparse(df, name, cap_max=cap_max)
                full.update(arrays)
            else:
                full[name] = np.ascontiguousarray(segment.gather(df, name))
        return full

    def _run_fused(self, segment: FusedSegment, df: DataFrame) -> DataFrame:
        n = len(df)
        if n == 0:
            return self._fallback(segment, df, count=False)
        try:
            full = self._gather(segment, df)
        except IneligibleBatch as e:
            metrics.counter(self.scope, MLMetrics.fallback_reason("batch", e.reason))
            return self._fallback(segment, df, count=True)

        device = self.device
        cuda = device.type == "cuda"
        chunk_rows = max(1, int(config.get(Options.BATCH_CHUNK_ROWS)))
        depth = max(1, int(config.get(Options.BATCH_PREFETCH_DEPTH)))
        starts = list(range(0, n, chunk_rows))
        chunk_hist = metrics.histogram(self.scope, MLMetrics.BATCH_CHUNK_MS)
        compute = torch.cuda.current_stream(device) if cuda else None
        copy_stream = torch.cuda.Stream(device) if cuda else None

        sharding = self.sharding

        def upload(lo: int, hi: int) -> Tuple[Any, int, bool]:
            # ``(device inputs, padded rows, replicated)`` of one chunk. On a
            # shard grid a chunk of a multiple of MIN_SHARD_ROWS rows pads up
            # to the mesh quantum (row 0 repeated) and splits over the data
            # shards; any other tail goes whole to each distinct device.
            rows = hi - lo
            if sharding is None:
                return {name: to_device(arr[lo:hi], device) for name, arr in full.items()}, rows, False
            if not sharding.shardable_rows(rows):
                return sharding.put_columns({name: arr[lo:hi] for name, arr in full.items()},
                                            replicated=True), rows, True
            padded = sharding.padded_rows(rows)
            pad = np.zeros(padded - rows, np.int64)
            return sharding.put_columns({name: arr[lo:hi] if padded == rows
                                         else np.concatenate([arr[lo:hi], arr[lo + pad]])
                                         for name, arr in full.items()}), padded, False

        def ingest(lo: int) -> Tuple[Hashable, Any, Optional[Any], int, bool]:
            # Contiguous row views of the gathered arrays onto the device: on
            # CUDA staged in pinned memory and copied on the side stream, so
            # the copy runs while the compute stream works on earlier chunks.
            hi = min(lo + chunk_rows, n)
            if not cuda:
                inputs, padded, replicated = upload(lo, hi)
                uploaded = None
            else:
                with torch.cuda.stream(copy_stream):
                    inputs, padded, replicated = upload(lo, hi)
                    uploaded = torch.cuda.Event()
                    uploaded.record(copy_stream)
            first = inputs if isinstance(inputs, dict) else inputs[0]
            key = tuple(
                (name, (padded,) + tuple(first[name].shape[1:]), str(first[name].dtype))
                for name in sorted(first)
            ) + (("replicated",) if replicated else ())
            return key, inputs, uploaded, padded, replicated

        def on_compile() -> None:
            metrics.counter(self.scope, MLMetrics.BATCH_COMPILES)

        # Declared outputs land in preallocated full-length host buffers, one
        # disjoint slice per chunk: no per-chunk array and no concatenate.
        out_bufs: Dict[str, np.ndarray] = {}
        out_decl: Dict[str, Any] = {}
        inflight: List[Tuple[float, Optional[Any], int, int, List[Tuple[str, torch.Tensor]]]] = []

        def finalize_oldest() -> None:
            t_dispatch, done, lo, hi, hosts = inflight.pop(0)
            if done is not None:
                done.synchronize()  # the chunk's readback copies have landed
            for name, host in hosts:
                # float32 → float64 is value-exact; [:hi - lo] drops a padded
                # chunk's pad rows
                out_bufs[name][lo:hi] = host.numpy()[:hi - lo]
            chunk_hist.observe((time.perf_counter() - t_dispatch) * 1000.0)

        nxt = ingest(starts[0])
        for i, lo in enumerate(starts):
            key, inputs, uploaded, padded, replicated = nxt
            hi = min(lo + chunk_rows, n)
            t_dispatch = time.perf_counter()
            if uploaded is not None:
                compute.wait_event(uploaded)
                for shard in ([inputs] if isinstance(inputs, dict) else inputs):
                    for t in shard.values():
                        t.record_stream(compute)  # allocated on the copy stream, used here
            outputs = run_segment(segment, key, inputs, on_compile=on_compile, on_plan=self._on_plan,
                                  replicated=replicated)
            pending = segment.pending(outputs)
            if sharding is not None:
                if replicated:
                    metrics.counter(self.scope, MLMetrics.BATCH_SHARD_REPLICATED_CHUNKS)
                else:
                    metrics.counter(self.scope, MLMetrics.BATCH_SHARD_ROWS, padded // sharding.n_data)
                    if padded != hi - lo:
                        metrics.counter(self.scope, MLMetrics.BATCH_SHARD_PAD_ROWS, padded - (hi - lo))
            if not out_bufs:  # shapes are fixed by the programs: allocate once
                for name, dtype, tensor, np_dtype in pending:
                    out_bufs[name] = np.empty((n,) + tuple(tensor.shape[1:]), np_dtype)
                    out_decl[name] = dtype
            hosts = []
            for name, _dtype, tensor, _np in pending:
                if cuda:
                    host = torch.empty(tuple(tensor.shape), dtype=tensor.dtype, pin_memory=True)
                    host.copy_(tensor, non_blocking=True)
                else:
                    host = tensor
                hosts.append((name, host))
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(compute)
            inflight.append((t_dispatch, done, lo, hi, hosts))
            if i + 1 < len(starts):
                nxt = ingest(starts[i + 1])  # overlaps the chunk just dispatched
            while len(inflight) >= depth:
                finalize_oldest()
        while inflight:
            finalize_oldest()

        metrics.counter(self.scope, MLMetrics.BATCH_FUSED_CHUNKS, len(starts))
        metrics.counter(self.scope, MLMetrics.BATCH_FUSED_ROWS, n)
        out = df.clone()
        sparse_parts: Dict[str, Dict[str, np.ndarray]] = {}
        for name, dtype in out_decl.items():
            host = out_bufs[name]
            if isinstance(dtype, tuple) and dtype and dtype[0] == SPARSE_MARK:
                # the three parts of a sparse output arrive in convention
                # order: add the column once the third is in
                _mark, col, dim, part = dtype
                parts = sparse_parts.setdefault(col, {})
                parts[part] = host
                if len(parts) == 3:
                    out.add_column(
                        col, DataTypes.vector(BasicType.DOUBLE),
                        rebuild_sparse_column(dim, parts["values"], parts["ids"], parts["nnz"]),
                    )
                continue
            if dtype is None:  # a shape-following output (Binarizer's)
                dtype = DataTypes.vector(BasicType.DOUBLE) if host.ndim == 2 else DataTypes.DOUBLE
            out.add_column(name, dtype, host)
        return out

    def _fallback(self, segment: FusedSegment, df: DataFrame, *, count: bool) -> DataFrame:
        """Per-stage execution of a fused segment's stages (an input the
        chain cannot take, or an empty frame not worth building for)."""
        if count:
            metrics.counter(self.scope, MLMetrics.BATCH_FALLBACK_SEGMENTS)
        for stage in segment.stages:
            out = stage.transform(df, device=self.device)
            df = out[0] if isinstance(out, (list, tuple)) else out
        return df
