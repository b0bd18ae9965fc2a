"""Stage-chain planner — twin of ``flink_ml_tpu/servable/planner.py``,
dense and sparse, on one device or on a plan's shard grid.

Consecutive :class:`~flink_ml_tpu_torch.servable.kernel_spec.KernelSpec`
stages form a :class:`FusedSegment`: its model arrays move to the device once
when the segment is built (the counterpart of ``device_put``), and per key
it builds a **chain** of programs that pass device tensors to each other —
one host→device ingest, one device→host readback, no DataFrame in between.

Program partition, as in the JAX package:

- exact tier (:func:`_partition_exact`): one program per spec, except that
  consecutive ``elementwise`` specs merge — bit-identical to the per-stage
  ``transform`` path;
- fast tier (:func:`_partition_fast`): maximal ``fusable`` runs become one
  program each, crossing reduction boundaries. Per key, the cost model
  (``servable/fusion.py``) may run a hot run as the hand-written CUDA
  megakernel instead (:func:`_fast_megakernels`), when one exists for the
  chain.

Sparse columns ride the sparse calling convention (``servable/sparse.py``):
a ``"sparse"``-kind input enters as its values/ids/nnz triple and an
``"entries"``-kind one as the quadruple its spec's host ingest featurizes
(:meth:`FusedSegment.gather_sparse`); a sparse output leaves as a triple and
is rebuilt into SparseVectors at readback. Which stages take the convention is
decided statically when the segments are built (:func:`build_segments`).

"Compiling" a key here means choosing each program's kind and recording the
key's input signature; PyTorch runs eagerly, so nothing is traced. A key is
whatever the caller ingests by: the serving bucket (and nnz cap), or the
batch plan's chunk signature (rows × column shapes and dtypes), each built
lazily the first time it is seen. A
megakernel that fails to build or launch raises: no merged program stands in
for it.

Mesh sharding (``servable/sharding.py``): a segment built with a
:class:`~flink_ml_tpu_torch.servable.sharding.PlanSharding` holds its model
tensors per data shard (``put_model``: one upload per distinct device,
wide 2-D arrays split over the model axis), and :func:`run_segment` runs the
key's chain once per data shard, on that shard's rows and device, then
concatenates each output column — one tensor per column, one readback per
batch. The program kind is chosen once per key at the bucket's rows, so a
data-sharded fast-tier key launches its megakernel once per shard where
mesh 1 launches it once; a segment with a model axis runs the merged
programs, as the JAX package's SPMD segments do. A ragged block the
caller cannot shard runs ``replicated``: once on each distinct device. A
segment with more than one data shard runs its programs inside
``ops/rowstable.py``'s ``required``, so on CUDA its bodies take their
row-stable forms; a mesh-1 segment stays on cuBLAS.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.ops import rowstable
from flink_ml_tpu_torch.servable.fusion import chain_score
from flink_ml_tpu_torch.servable.kernel_spec import SPARSE_KINDS
from flink_ml_tpu_torch.servable.megakernels import build_megakernel_fn, chain_eligible, inputs_fit
from flink_ml_tpu_torch.servable.sparse import (
    SPARSE_MARK,
    OffLadderError,
    pack_sparse_column,
    rebuild_sparse_column,
    sparse_names,
)

__all__ = [
    "IneligibleBatch",
    "FusedSegment",
    "FallbackStage",
    "PlanExecution",
    "build_segments",
    "run_segment",
    "to_device",
]

#: Program kinds a built chain may carry (the ``ml.fusion.*`` vocabulary).
PLAN_EXACT = "exact"
PLAN_FUSED = "fused"
PLAN_MEGAKERNEL = "megakernel"


class IneligibleBatch(Exception):
    """This batch cannot ride the segment's chain — fall back to per-stage.
    ``reason`` labels the per-reason fallback counter: ``"sparse"`` (a sparse
    column where the segment expects a dense kind), ``"ragged"`` (a column
    that is not a dense numeric array), ``"off_ladder"`` (nnz above
    ``sparse.nnz.cap.max``), ``"signature"`` (shape or dim differing from the
    key's recorded signature)."""

    def __init__(self, message: str, reason: str = "ragged"):
        super().__init__(message)
        self.reason = reason


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array onto ``device`` — int32 (ids, nnz) as it is, anything
    else as float32. For CUDA the bytes are staged in pinned memory
    (PyTorch's caching host allocator) and copied with ``non_blocking=True``
    on the current stream, so the copy queues behind the work already
    dispatched instead of synchronising with it."""
    dtype = np.int32 if arr.dtype == np.int32 else np.float32
    host = torch.from_numpy(np.require(arr, dtype, ["C", "W"]))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class _Program:
    """One program of a segment's chain: a single spec, a merged run of
    elementwise specs (exact tier) or a maximal fusable run (fast tier).
    ``shard_models[s]`` holds each spec's model tensors on data shard ``s``
    (one entry on one device); ``models`` is shard 0's."""

    __slots__ = ("specs", "shard_models", "inputs", "kind")

    def __init__(self, specs: Sequence[Any], shard_models: Sequence[Sequence[Dict[str, Any]]],
                 kind: str):
        self.specs = tuple(specs)
        self.shard_models = tuple(tuple(m) for m in shard_models)
        self.kind = kind
        needed: List[str] = []
        produced: set = set()
        for spec in self.specs:
            for col in spec.input_cols:
                for name in spec.program_input_names(col):
                    if name not in produced and name not in needed:
                        needed.append(name)
            produced.update(spec.program_outputs)
        self.inputs: Tuple[str, ...] = tuple(needed)

    @property
    def models(self) -> Tuple[Dict[str, Any], ...]:
        return self.shard_models[0]

    def __call__(self, cols: Dict[str, torch.Tensor], shard: int = 0) -> Dict[str, torch.Tensor]:
        cols = dict(cols)
        outs: Dict[str, torch.Tensor] = {}
        for spec, model in zip(self.specs, self.shard_models[shard]):
            stage_out = spec.kernel_fn(model, cols)
            cols.update(stage_out)
            outs.update(stage_out)
        return outs


class _MegaProgram:
    """A hot fast-tier run as the hand-written megakernel — same calling
    convention as :class:`_Program`."""

    __slots__ = ("specs", "shard_models", "inputs", "kind", "_fn")

    def __init__(self, program: _Program, mega_fn: Callable):
        self.specs = program.specs
        self.shard_models = program.shard_models
        self.inputs = program.inputs
        self.kind = PLAN_MEGAKERNEL
        self._fn = mega_fn

    def __call__(self, cols: Dict[str, torch.Tensor], shard: int = 0) -> Dict[str, torch.Tensor]:
        return self._fn(self.shard_models[shard], cols)


def _partition_exact(specs: Sequence[Any]) -> List[Tuple[int, int]]:
    """One program per spec, except consecutive ``elementwise`` specs merge."""
    runs: List[Tuple[int, int]] = []
    i = 0
    while i < len(specs):
        j = i + 1
        if specs[i].elementwise:
            while j < len(specs) and specs[j].elementwise:
                j += 1
        runs.append((i, j))
        i = j
    return runs


def _partition_fast(specs: Sequence[Any]) -> List[Tuple[int, int]]:
    """Maximal runs of ``fusable`` specs become one program each."""
    runs: List[Tuple[int, int]] = []
    i = 0
    while i < len(specs):
        j = i + 1
        if specs[i].fusable:
            while j < len(specs) and specs[j].fusable:
                j += 1
        runs.append((i, j))
        i = j
    return runs


def _fast_megakernels(programs: Sequence[_Program]) -> Dict[int, _MegaProgram]:
    """Megakernel candidates per fast-tier program index — only for runs
    with a hand-written kernel (``megakernels.chain_eligible``). Whether a
    candidate runs is the cost model's call per key in :func:`run_segment`."""
    return {
        idx: _MegaProgram(prog, build_megakernel_fn(prog.specs))
        for idx, prog in enumerate(programs)
        if chain_eligible(prog.specs)
    }


class FusedSegment:
    """A maximal run of consecutive kernel-spec stages with its per-key chains."""

    __slots__ = (
        "stages", "specs", "external_inputs", "device", "shard_models", "programs",
        "compiled", "signatures", "fusion", "sharding", "mega", "plan_kinds",
        "has_sparse_inputs",
    )

    def __init__(self, staged: Sequence[Tuple[Any, Any]], device: torch.device,
                 fusion: Optional[Any] = None, sharding: Optional[Any] = None):
        self.stages = [stage for stage, _ in staged]
        self.specs = [spec for _, spec in staged]
        self.sharding = sharding
        self.device = device if sharding is None else sharding.data_devices[0]
        self.fusion = fusion  # resolved FusionTier, or None ≡ exact
        produced: set = set()
        external: List[str] = []
        for spec in self.specs:
            for col in spec.input_cols:
                if all(n in produced for n in spec.program_input_names(col)):
                    continue
                if col not in external:
                    external.append(col)
            produced.update(spec.program_outputs)
        self.external_inputs: Tuple[str, ...] = tuple(external)
        #: Whether an external input rides the sparse convention — such a
        #: segment keys its chains by (bucket, nnz cap).
        self.has_sparse_inputs = any(self.input_kind(n) in SPARSE_KINDS for n in external)
        # One upload per model array (per distinct device of a shard grid),
        # when the segment is built (warmup/swap time): the hot path only
        # ever passes these tensors back in.
        if sharding is None:
            per_shard = [tuple(
                {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in spec.model_arrays.items()}
                for spec in self.specs
            )]
        else:
            placed = [{k: sharding.put_model(v) for k, v in spec.model_arrays.items()}
                      for spec in self.specs]
            per_shard = [tuple({k: v[s] for k, v in spec.items()} for spec in placed)
                         for s in range(sharding.n_data)]
        #: data shard -> each spec's model tensors (one entry on one device)
        self.shard_models: Tuple[Tuple[Dict[str, Any], ...], ...] = tuple(per_shard)
        if fusion is not None and fusion.fast:
            runs, kind = _partition_fast(self.specs), PLAN_FUSED
        else:
            runs, kind = _partition_exact(self.specs), PLAN_EXACT
        self.programs: List[_Program] = [
            _Program(self.specs[i:j], [m[i:j] for m in self.shard_models], kind) for i, j in runs
        ]
        #: fast tier only: program index -> megakernel candidate; none on a
        #: model axis, whose split arrays only the merged programs read
        self.mega: Dict[int, _MegaProgram] = {}
        if (fusion is not None and fusion.fast and fusion.megakernel
                and (sharding is None or sharding.n_model == 1)):
            self.mega = _fast_megakernels(self.programs)
        #: key -> the chain of programs chosen for it, in order
        self.compiled: Dict[Hashable, List[Any]] = {}
        #: key -> {input name: (shape, dtype)} recorded when the chain was built
        self.signatures: Dict[Hashable, Dict[str, Tuple[Tuple[int, ...], Any]]] = {}
        #: key -> program kinds chosen for it
        self.plan_kinds: Dict[Hashable, Tuple[str, ...]] = {}

    def input_kind(self, name: str) -> str:
        """The ingest accessor of an external input: the first consuming
        spec's declared kind."""
        for spec in self.specs:
            if name in spec.input_cols:
                return spec.input_kind(name)
        return "vector"

    def gather(self, df: DataFrame, name: str) -> np.ndarray:
        """One host-side read of a dense external input column, the way the
        consuming stage's ``transform`` reads it, as float32. Raises
        :class:`IneligibleBatch` for anything a chain cannot take."""
        if df.is_sparse(name):
            raise IneligibleBatch(f"column {name!r} is sparse", reason="sparse")
        try:
            kind = self.input_kind(name)
            if kind == "scalar":
                return df.scalars(name, np.float32)
            if kind == "dense":
                col = df.column(name)
                if not isinstance(col, np.ndarray):
                    raise IneligibleBatch(f"column {name!r} is ragged: the per-stage path owns it")
                return np.asarray(col, np.float32)
            return np.asarray(df.vectors(name), np.float32)
        except IneligibleBatch:
            raise
        except (ValueError, TypeError, KeyError) as e:  # ragged / non-numeric / missing
            raise IneligibleBatch(f"column {name!r} not fusable: {e}") from e

    def gather_sparse(
        self,
        df: DataFrame,
        name: str,
        *,
        cap: Optional[int] = None,
        cap_max: Optional[int] = None,
        truncate: bool = False,
    ) -> Tuple[Dict[str, np.ndarray], int]:
        """One host-side pack of a sparse-convention external input at a
        ladder cap (``servable/sparse.py``): a ``"sparse"`` column packs its
        SparseVectors, an ``"entries"`` column runs the consuming spec's host
        featurizer. Returns ``(arrays, nnz_cap)``. Raises
        :class:`IneligibleBatch` for what the convention cannot take: rows
        over ``cap_max`` (``off_ladder``), a column that is not sparse or of
        another dim (``signature``)."""
        if self.input_kind(name) == "entries":
            ingest = next(s.host_ingests[name] for s in self.specs if name in s.host_ingests)
            try:
                arrays, used_cap, _total = ingest(df, cap, cap_max, truncate)
            except OffLadderError as e:
                raise IneligibleBatch(str(e), reason="off_ladder") from e
            except (ValueError, TypeError, KeyError) as e:  # a column the featurizer cannot read
                raise IneligibleBatch(f"column {name!r} not featurizable: {e}") from e
            return arrays, used_cap
        if not df.is_sparse(name):
            raise IneligibleBatch(
                f"column {name!r} is not sparse — the segment expects the sparse convention",
                reason="signature",
            )
        dim = next((s.sparse_input_dims[name] for s in self.specs
                    if name in s.sparse_input_dims), None)
        try:
            arrays, used_cap, _dim, _total = pack_sparse_column(
                df, name, dim=dim, cap=cap, cap_max=cap_max, truncate=truncate
            )
        except OffLadderError as e:
            raise IneligibleBatch(str(e), reason="off_ladder") from e
        except ValueError as e:  # dim mismatch
            raise IneligibleBatch(f"column {name!r} not packable: {e}", reason="signature") from e
        return arrays, used_cap

    @property
    def outputs(self) -> List[Tuple[str, Any]]:
        out: List[Tuple[str, Any]] = []
        for spec in self.specs:
            out.extend(spec.outputs)
        return out

    def plan_label(self, key: Hashable) -> str:
        """The fusion tier the chain built for ``key`` runs at: ``"exact"``,
        ``"fast"`` (merged programs) or ``"fast+mega"`` (at least one program
        on a hand-written megakernel)."""
        kinds = self.plan_kinds.get(key, ())
        if PLAN_MEGAKERNEL in kinds:
            return "fast+mega"
        if PLAN_FUSED in kinds:
            return "fast"
        return PLAN_EXACT

    def pending(self, outputs: Dict[str, torch.Tensor]) -> List[Tuple[str, Any, torch.Tensor, Any]]:
        """Readback-ready ``(name, DataType, device tensor, numpy dtype)`` for
        every declared stage output, in ``add_column`` order. A sparse output
        expands to its three parts, the DataType slot carrying the
        ``(SPARSE_MARK, column, dim, part)`` marker the readback rebuilds the
        SparseVector column from."""
        out = []
        for spec in self.specs:
            for name, dtype in spec.outputs:
                if name in spec.sparse_outputs:
                    dim = spec.sparse_outputs[name]
                    for part, pname, np_dtype in zip(
                        ("values", "ids", "nnz"), sparse_names(name),
                        (np.float64, np.int64, np.int64),
                    ):
                        out.append((pname, (SPARSE_MARK, name, dim, part), outputs[pname], np_dtype))
                else:
                    out.append((name, dtype, outputs[name], np.float64))
        return out


class FallbackStage:
    """A stage served through its ordinary ``transform`` (no kernel spec)."""

    __slots__ = ("stage",)

    def __init__(self, stage):
        self.stage = stage


def build_segments(stages: Sequence[Any], device: torch.device,
                   fusion: Optional[Any] = None,
                   sparse: Optional[Dict[str, int]] = None,
                   sharding: Optional[Any] = None) -> List[Any]:
    """Group consecutive kernel-spec stages into :class:`FusedSegment` runs,
    everything else into :class:`FallbackStage`. Raises whatever
    ``kernel_spec()`` raises (an unloaded model fails at plan build). With a
    ``sharding`` (:class:`~flink_ml_tpu_torch.servable.sharding.PlanSharding`)
    the segments hold their model tensors on its shard grid.

    ``sparse`` turns on the sparse calling convention: the ``{column: dim}``
    of inputs known to arrive sparse (the serving template's), or None when
    ``sparse.fastpath`` is off. Sparseness then propagates statically:
    before asking a stage for its dense spec, the planner offers the
    known-sparse set to its ``sparse_kernel_spec(known)``; a stage whose
    input arrives sparse returns a sparse-convention spec, and its
    ``sparse_outputs`` join the known set for the stages after it."""
    segments: List[Any] = []
    run: List[Tuple[Any, Any]] = []
    known: Dict[str, int] = dict(sparse or {})
    for stage in stages:
        spec = None
        if sparse is not None and hasattr(stage, "sparse_kernel_spec"):
            spec = stage.sparse_kernel_spec(dict(known))
        if spec is None and hasattr(stage, "kernel_spec"):
            spec = stage.kernel_spec()
        if spec is not None:
            run.append((stage, spec))
            known.update(spec.sparse_outputs)
            for name in spec.output_names:
                if name not in spec.sparse_outputs:
                    known.pop(name, None)  # a densely overwritten column
            continue
        if run:
            segments.append(FusedSegment(run, device, fusion, sharding))
            run = []
        # A fallback stage's outputs are opaque: the known set keeps the
        # hints of columns no spec touched; a stage that densifies a hinted
        # column shows up as a per-batch signature fallback, never a wrong
        # answer.
        segments.append(FallbackStage(stage))
    if run:
        segments.append(FusedSegment(run, device, fusion, sharding))
    return segments


def _program_shapes(inputs: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    """``(rows, dense width, nnz cap)`` of a key's program inputs: the
    widest 2-D dense input, and the width of the sparse ``!ids`` inputs,
    which feeds the cost model's per-slot term instead."""
    rows = next(iter(inputs.values())).shape[0] if inputs else 0
    width = max((int(a.shape[1]) for n, a in inputs.items() if a.dim() == 2 and "!" not in n),
                default=0)
    nnz_cap = max((int(a.shape[1]) for n, a in inputs.items() if n.endswith("!ids") and a.dim() == 2),
                  default=0)
    return rows, width, nnz_cap


def _shard_inputs(segment: FusedSegment, inputs: Any, replicated: bool) -> List[Tuple[int, Dict[str, torch.Tensor]]]:
    """``[(data shard, its program inputs), ...]`` of one batch: a sharded
    segment takes ``PlanSharding.put_columns``'s list of per-shard dicts (per
    replica for a replicated block) or one dict of whole columns, split here
    into ``n_data`` row views; one device takes one dict."""
    sharding = segment.sharding
    if sharding is None:
        return [(0, inputs)]
    if replicated:
        blocks = [inputs] if isinstance(inputs, dict) else list(inputs)
        return list(zip(sharding.replica_shards(), blocks))
    if isinstance(inputs, dict):
        rows = next(iter(inputs.values())).shape[0] if inputs else 0
        if rows % sharding.n_data:
            raise IneligibleBatch(
                f"{rows} rows not divisible by the {sharding.n_data}-way data axis — "
                "pad to a mesh multiple or run replicated"
            )
        m = rows // sharding.n_data
        inputs = [{n: t[i * m:(i + 1) * m] for n, t in inputs.items()} for i in range(sharding.n_data)]
    if len(inputs) != sharding.n_data or len({next(iter(s.values())).shape[0] for s in inputs if s}) > 1:
        raise IneligibleBatch(f"{len(inputs)} uneven row shards for the {sharding.n_data}-way data axis")
    return list(enumerate(inputs))


def run_segment(
    segment: FusedSegment,
    key: Hashable,
    inputs: Any,
    *,
    on_compile: Optional[Callable[[], None]] = None,
    on_plan: Optional[Callable[[str, float], None]] = None,
    replicated: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the segment's chain for ``key`` on device ``inputs`` (a dict of
    columns; on a shard grid also a list of per-shard dicts, see
    :func:`_shard_inputs`). The first time a key is seen its chain is built:
    ``on_compile()`` once, and ``on_plan(kind, score)`` per program with the
    cost model's choice (a megakernel candidate runs when the key's input
    columns fit its kernel and the score at the whole block's rows — and nnz
    cap, for a sparse chain — clears the tier's bar). On a shard grid the
    chain runs once per data shard and each output comes back as one tensor
    of the block's rows, on shard 0's device; a ``replicated`` block runs
    once on each distinct device and returns the first run's outputs (the
    caller keys replicated blocks apart)."""
    shards = _shard_inputs(segment, inputs, replicated)
    chain = segment.compiled.get(key)
    if chain is None:
        if on_compile is not None:
            on_compile()
        first = shards[0][1]
        rows, width, nnz_cap = _program_shapes(first)
        if not replicated:
            rows *= len(shards)
        chain = []
        for idx, prog in enumerate(segment.programs):
            mega = segment.mega.get(idx)
            if (mega is not None
                    and inputs_fit(prog.specs, {n: first[n] for n in prog.inputs if n in first})
                    and segment.fusion.megakernel_hot(prog.specs, rows, width, nnz_cap)):
                prog = mega
            if on_plan is not None:
                on_plan(prog.kind, chain_score(prog.specs, rows, width, nnz_cap))
            chain.append(prog)
        segment.compiled[key] = chain
        segment.plan_kinds[key] = tuple(p.kind for p in chain)
        segment.signatures[key] = {
            name: ((rows,) + tuple(arr.shape[1:]), arr.dtype) for name, arr in first.items()
        }
    runs = []
    # more than one data shard: the bodies take their row-stable forms on
    # CUDA too, so a shard's rows keep the bits they have in the bucket
    with rowstable.required(segment.sharding is not None and segment.sharding.n_data > 1):
        for shard, cols in shards:
            cols = dict(cols)
            outs: Dict[str, torch.Tensor] = {}
            for prog in chain:
                prog_out = prog({n: cols[n] for n in prog.inputs}, shard)
                cols.update(prog_out)
                outs.update(prog_out)
            runs.append(outs)
    if replicated or len(runs) == 1:
        return runs[0]
    device = segment.device
    return {name: torch.cat([r[name].to(device) for r in runs]) for name in runs[0]}


class PlanExecution:
    """A dispatched batch: the host DataFrame so far plus trailing fused
    outputs still on the device. ``finalize`` is the one blocking readback."""

    __slots__ = ("_df", "_pending")

    def __init__(self, df: DataFrame, pending: List[Tuple[str, Any, torch.Tensor, Any]]):
        self._df = df
        self._pending = pending

    def finalize(self) -> DataFrame:
        """Copy the outputs to the host (waiting for the device), float32
        widened value-exactly to float64 and ids to int64 as in the JAX
        package's readback; a sparse output's three parts are rebuilt into
        one SparseVector column; an output declared without a DataType
        leaves as a DOUBLE scalar column when 1-D, a vector column when 2-D."""
        if not self._pending:
            return self._df
        out = self._df.clone()
        sparse_parts: Dict[str, Dict[str, np.ndarray]] = {}
        for name, dtype, tensor, np_dtype in self._pending:
            host = tensor.cpu().numpy().astype(np_dtype)
            if isinstance(dtype, tuple) and dtype and dtype[0] == SPARSE_MARK:
                # parts arrive adjacent, in convention order: add the column
                # once the third has come back
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
