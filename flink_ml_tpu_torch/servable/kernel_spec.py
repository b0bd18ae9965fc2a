"""KernelSpec — a transform as a pure, fusable device program.

Twin of ``flink_ml_tpu/servable/kernel_spec.py``. A stage that is row-wise
and numerically pure describes itself as a spec, and the planner
(``servable/planner.py``) composes consecutive specs into per-key chains with
device-resident model tensors:

- ``input_cols`` — columns the kernel reads, each ingested the way
  ``transform`` reads it; ``input_kinds`` picks the accessor per column:

  * ``"vector"`` (default) — ``df.vectors(col)``: dense [n, d] float32;
  * ``"scalar"`` — ``df.scalars(col)``: a [n] float32 scalar column;
  * ``"dense"`` — ``df.column(col)`` must already be an ndarray, kept at its
    shape (a list column falls back, as its per-stage path does host math);
  * ``"sparse"`` — the sparse calling convention (``servable/sparse.py``):
    the column enters as ``col!values`` / ``col!ids`` / ``col!nnz`` packed
    at a ladder nnz cap, and ``kernel_fn`` reads the expanded names;
  * ``"entries"`` — host-featurized raw entries (token hashing, vocabulary
    lookup): the spec's ``host_ingests[col]`` builds the quadruple
    ``!values`` / ``!ids`` / ``!nnz`` / ``!len`` on the host at ingest, and
    the device kernel owns the duplicate combine.

  The JAX package's ``"shape"`` kind is not ported yet (ROADMAP.md);
- ``outputs`` — ``(column name, DataType)`` pairs in ``add_column`` order; a
  None DataType takes the output's shape at readback (a DOUBLE scalar
  column for a 1-D result, a vector column for a 2-D one), for stages whose
  output shape follows the input (Binarizer); ``sparse_outputs`` maps those
  that leave in the sparse convention to their dimension (``kernel_fn``
  returns their expanded names);
- ``sparse_input_dims`` — the expected dimension of each ``"sparse"`` input
  (a packed batch of another dim falls back per-stage);
- ``model_arrays`` — name → host ndarray in the dtype the kernel consumes,
  moved to the device once when the plan is built;
- ``kernel_fn(model_tensors, column_tensors) -> {name: tensor}`` — pure
  PyTorch math from ``ops/kernels.py``;
- ``elementwise`` — the body has no cross-element accumulation, so the exact
  tier may merge it with its elementwise neighbours;
- ``fusable`` — whether ``fusion.mode=fast`` may merge it across a reduction;
- ``fusion_op`` — the op id naming this body in the megakernel vocabulary
  (``servable/megakernels.py``), or None;
- ``fusion_params`` — the static arguments the hand-written megakernel needs
  to run this body (the scaler's ``with_mean``/``with_std``, the KMeans
  measure, Normalizer's ``p``, Binarizer's ``thresholds``, Imputer's
  placeholder); a Pallas kernel traces ``kernel_fn`` and needs none, a CUDA
  kernel cannot read a closure;
- ``host_ingests`` — for each ``"entries"`` input,
  ``fn(df, cap, cap_max, truncate) -> (arrays, cap, nnz_total)``: the host
  featurizer the ingest runs, never inside a program;
- ``sparse_flops_per_nnz`` — the cost model's FLOPs per entry slot of a
  sparse spec (``servable/fusion.py``; default there).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from flink_ml_tpu_torch.servable.sparse import entries_names, sparse_names

__all__ = ["KernelSpec", "SPARSE_KINDS"]

_VALID_KINDS = ("vector", "scalar", "dense", "sparse", "entries")

#: Input kinds that ride the sparse calling convention: ``"sparse"`` (a
#: SparseVector column packed to the triple) and ``"entries"`` (a
#: host-featurized column packed to the quadruple by its ``host_ingest``).
SPARSE_KINDS = ("sparse", "entries")


class KernelSpec:
    """Pure-kernel description of one pipeline stage (see module docstring)."""

    __slots__ = ("input_cols", "outputs", "model_arrays", "kernel_fn", "input_kinds",
                 "elementwise", "fusable", "fusion_op", "fusion_params", "sparse_outputs",
                 "sparse_input_dims", "host_ingests", "sparse_flops_per_nnz")

    def __init__(
        self,
        *,
        input_cols: Sequence[str],
        outputs: Sequence[Tuple[str, Any]],
        model_arrays: Mapping[str, np.ndarray],
        kernel_fn: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]],
        input_kinds: Optional[Mapping[str, str]] = None,
        elementwise: bool = False,
        fusable: bool = True,
        fusion_op: Optional[str] = None,
        fusion_params: Optional[Mapping[str, Any]] = None,
        sparse_outputs: Optional[Mapping[str, int]] = None,
        sparse_input_dims: Optional[Mapping[str, int]] = None,
        host_ingests: Optional[Mapping[str, Callable]] = None,
        sparse_flops_per_nnz: Optional[float] = None,
    ):
        self.input_cols: Tuple[str, ...] = tuple(input_cols)
        self.outputs: Tuple[Tuple[str, Any], ...] = tuple(outputs)
        self.model_arrays: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in model_arrays.items()
        }
        self.kernel_fn = kernel_fn
        self.input_kinds: Dict[str, str] = dict(input_kinds or {})
        for name, kind in self.input_kinds.items():
            if kind not in _VALID_KINDS:
                raise ValueError(
                    f"input kind {kind!r} for column {name!r}; the port takes "
                    f"{_VALID_KINDS} (the others are still to port, see ROADMAP.md)"
                )
        self.elementwise = bool(elementwise)
        self.fusable = bool(fusable)
        if fusion_op is not None and not isinstance(fusion_op, str):
            raise ValueError(f"fusion_op must be a string op id; got {fusion_op!r}")
        self.fusion_op = fusion_op
        self.fusion_params: Dict[str, Any] = dict(fusion_params or {})
        self.sparse_outputs: Dict[str, int] = {k: int(v) for k, v in (sparse_outputs or {}).items()}
        for name in self.sparse_outputs:
            if name not in self.output_names:
                raise ValueError(f"sparse output {name!r} not in outputs")
        self.sparse_input_dims: Dict[str, int] = {
            k: int(v) for k, v in (sparse_input_dims or {}).items()
        }
        self.host_ingests: Dict[str, Callable] = dict(host_ingests or {})
        for name, kind in self.input_kinds.items():
            if kind == "entries" and name not in self.host_ingests:
                raise ValueError(f"entries-kind column {name!r} needs a host_ingests entry")
        self.sparse_flops_per_nnz = (
            None if sparse_flops_per_nnz is None else float(sparse_flops_per_nnz)
        )

    @property
    def output_names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.outputs)

    @property
    def is_sparse(self) -> bool:
        """Whether any input or output rides the sparse convention."""
        return bool(self.sparse_outputs) or any(k in SPARSE_KINDS for k in self.input_kinds.values())

    def input_kind(self, name: str) -> str:
        return self.input_kinds.get(name, "vector")

    def program_input_names(self, col: str) -> Tuple[str, ...]:
        """The program-level names one input column expands to: the
        convention triple for a sparse column, the quadruple for an entries
        column, the column itself otherwise."""
        kind = self.input_kind(col)
        if kind == "sparse":
            return sparse_names(col)
        if kind == "entries":
            return entries_names(col)
        return (col,)

    @property
    def program_outputs(self) -> Tuple[str, ...]:
        """Every program-level output name, in declaration order: the
        convention triple for a sparse output, the column itself otherwise."""
        out: Tuple[str, ...] = ()
        for name in self.output_names:
            out += sparse_names(name) if name in self.sparse_outputs else (name,)
        return out

    def __repr__(self) -> str:
        return (
            f"KernelSpec(inputs={list(self.input_cols)}, "
            f"outputs={list(self.output_names)}, "
            f"model_arrays={list(self.model_arrays)})"
        )
