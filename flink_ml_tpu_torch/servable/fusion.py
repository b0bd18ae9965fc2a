"""FusionTier — the cost-based fusion policy of the compiled plans.

Twin of ``flink_ml_tpu/servable/fusion.py`` for dense chains. ``fusion.mode``:

- ``exact`` (default) — per-stage programs, elementwise-only merges,
  bit-identical to the per-stage ``transform`` path;
- ``fast`` — maximal ``fusable`` runs merge into one program crossing
  reduction boundaries, and a chain the cost model marks hot runs as the
  hand-written CUDA megakernel (``servable/megakernels.py``). Results carry
  the per-chain ulp envelope :data:`ULP_ENVELOPE` instead of bit-equality.

The cost model (rows × estimated per-row FLOPs from the model-array shapes,
or from the nnz cap for a sparse spec, plus the ingest traffic term) is the
JAX package's, so both packages choose the same program kind for the same
shapes.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics

__all__ = [
    "FUSION_EXACT",
    "FUSION_FAST",
    "SPARSE_FLOPS_PER_NNZ",
    "ULP_ENVELOPE",
    "FusionTier",
    "chain_score",
    "plan_recorder",
    "resolve_fusion_tier",
    "spec_flops_per_row",
    "ulp_diff",
]

FUSION_EXACT = "exact"
FUSION_FAST = "fast"

#: The fast tier's accuracy contract in float32 ulps per chain: the largest
#: elementwise ulp distance between a fast-tier output and the exact-tier
#: output of the same chain on the same input bits. Same values as the JAX
#: package. ``scale_logistic`` is sized for saturated sigmoid tails, where a
#: margin error of k ulps becomes ≈ k·|margin| ulps of relative movement on
#: p ≈ e^margin; the thresholded class prediction stays identical.
ULP_ENVELOPE = {
    "scale_logistic": 32_768,
    "feature6": 1024,
    "scale_mlp": 16_384,
    "sparse_idf_logistic": 32_768,
}


#: FLOPs one entry slot of a sparse spec costs by default (gather, multiply,
#: segment add, bookkeeping) — the per-nnz analogue of the dense estimate.
SPARSE_FLOPS_PER_NNZ = 8.0


def spec_flops_per_row(spec: Any, nnz_cap: int = 0) -> float:
    """Estimated FLOPs one row pays in ``spec``'s kernel. A dense spec: 8,
    plus 2·size per 2-D model array (matmul operands) and 1·size per 1-D
    array (broadcast operands). A sparse spec is costed by what it touches,
    not what it addresses: 8 plus ``sparse_flops_per_nnz`` × ``nnz_cap``,
    the padded slots included (the padding-waste term)."""
    if getattr(spec, "is_sparse", False):
        declared = getattr(spec, "sparse_flops_per_nnz", None)
        per_nnz = SPARSE_FLOPS_PER_NNZ if declared is None else float(declared)
        return 8.0 + per_nnz * float(max(0, nnz_cap))
    total = 8.0  # floor: every kernel pays at least a few elementwise ops
    for arr in spec.model_arrays.values():
        a = np.asarray(arr)
        total += (2.0 if a.ndim >= 2 else 1.0) * float(a.size)
    return total


def chain_score(specs: Sequence[Any], rows: int, width: int = 0, nnz_cap: int = 0) -> float:
    """Hotness of running ``specs`` as one chain at ``rows``: per-row FLOPs
    (sparse specs at the chain's ``nnz_cap``) plus 4 bytes × ``width`` (the
    widest dense ingest column) per stage, times rows. Monotone in rows,
    width, nnz cap and every model-array size."""
    per_row = sum(spec_flops_per_row(s, nnz_cap) for s in specs) + 4.0 * width * len(specs)
    return rows * per_row


class FusionTier:
    """Resolved fusion policy for one compiled plan — immutable."""

    __slots__ = ("mode", "megakernel", "min_score")

    def __init__(self, mode: str, megakernel: bool = True, min_score: float = 1e6):
        if mode not in (FUSION_EXACT, FUSION_FAST):
            raise ValueError(
                f"fusion.mode must be {FUSION_EXACT!r} or {FUSION_FAST!r}; got {mode!r}"
            )
        self.mode = mode
        self.megakernel = bool(megakernel)
        self.min_score = float(min_score)

    @property
    def fast(self) -> bool:
        return self.mode == FUSION_FAST

    @property
    def key(self) -> Tuple[str, bool, float]:
        """Cache identity: a plan built under one key is stale under another."""
        return (self.mode, self.megakernel, self.min_score)

    def megakernel_hot(self, specs: Sequence[Any], rows: int, width: int = 0,
                       nnz_cap: int = 0) -> bool:
        """Whether the cost model marks this chain hot enough for the
        megakernel at ``rows`` (and ``nnz_cap``, for a sparse chain; fast
        mode only)."""
        if not (self.fast and self.megakernel):
            return False
        return chain_score(specs, rows, width, nnz_cap) >= self.min_score

    def __repr__(self) -> str:
        return (
            f"FusionTier(mode={self.mode!r}, megakernel={self.megakernel}, "
            f"min_score={self.min_score:g})"
        )


def resolve_fusion_tier(mode: Optional[str] = None) -> FusionTier:
    """The fusion policy of the current config, or of an explicit ``mode``.
    Raises ``ValueError`` on an unknown mode."""
    return FusionTier(
        mode if mode is not None else config.get(Options.FUSION_MODE),
        megakernel=config.get(Options.FUSION_MEGAKERNEL),
        min_score=config.get(Options.FUSION_MEGAKERNEL_MIN_SCORE),
    )


#: Program kind -> ml.fusion.plan.choice gauge value.
_PLAN_CHOICE = {"exact": 0, "fused": 1, "megakernel": 2}
_PLAN_COUNTER = {
    "exact": MLMetrics.FUSION_PROGRAMS_EXACT,
    "fused": MLMetrics.FUSION_PROGRAMS_FUSED,
    "megakernel": MLMetrics.FUSION_PROGRAMS_MEGAKERNEL,
}


def plan_recorder(scope: str):
    """The ``on_plan(kind, score)`` callback the serving plan hands to
    ``planner.run_segment``: counts each built program under its kind
    (``ml.fusion.programs.*``) and publishes the plan-choice and score gauges."""

    def on_plan(kind: str, score: float) -> None:
        metrics.counter(scope, _PLAN_COUNTER[kind])
        metrics.gauge(scope, MLMetrics.FUSION_PLAN_CHOICE, _PLAN_CHOICE[kind])
        metrics.gauge(scope, MLMetrics.FUSION_PLAN_SCORE, score)

    return on_plan


def ulp_diff(a, b) -> int:
    """Max elementwise ulp distance between two arrays compared as float32.
    NaNs must match positionally; ±0 compare equal."""
    fa = np.asarray(a, np.float32).ravel()
    fb = np.asarray(b, np.float32).ravel()
    if fa.shape != fb.shape:
        raise ValueError(f"shape mismatch: {fa.shape} vs {fb.shape}")
    nan_a, nan_b = np.isnan(fa), np.isnan(fb)
    if not np.array_equal(nan_a, nan_b):
        return np.iinfo(np.int32).max
    ia = fa.view(np.int32).astype(np.int64)
    ib = fb.view(np.int32).astype(np.int64)
    # Fold the sign-magnitude encoding onto a monotone integer line so the
    # distance across ±0 is 0, not 2**31.
    ia = np.where(ia >= 0, ia, -(ia & 0x7FFFFFFF))
    ib = np.where(ib >= 0, ib, -(ib & 0x7FFFFFFF))
    ok = ~nan_a
    if not ok.any():
        return 0
    return int(np.max(np.abs(ia[ok] - ib[ok])))
