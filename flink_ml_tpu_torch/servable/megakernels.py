"""The megakernel tier: a whole hot chain as ONE hand-written CUDA kernel.

Twin of ``flink_ml_tpu/servable/megakernels.py``. There, ``build_megakernel_fn``
traces any chain of kernel specs over its eleven fusion ops into one
row-tiled Pallas kernel. A CUDA kernel cannot trace Python bodies, so here a
chain runs either on a kernel written for it, or on a table kernel, which
composes its chain at launch from a small op table. :func:`chain_eligible`
admits every chain of those eleven ops (:data:`TABLE_OPS`) whose specs are
of their op's form, on these routes:

- the dedicated chains (:data:`MEGAKERNEL_CHAINS`), each on its own kernel:

  * ``("scale", "logistic")`` — StandardScaler → LogisticRegression, and
    ``("logistic",)`` — LogisticRegression alone:
    ``csrc/megakernel_scale_logistic.cu`` through :func:`scale_logistic`;
  * ``("sparse_idf", "sparse_logistic")`` — IDF → LogisticRegression on a
    SparseVector column in the sparse calling convention, and
    ``("sparse_logistic",)`` — the sparse head alone:
    ``csrc/megakernel_sparse_idf_logistic.cu`` through :func:`sparse_idf_logistic`;
  * ``("scale", "kmeans")`` — StandardScaler → KMeans, and ``("kmeans",)`` —
    the closest-centroid assignment alone: ``csrc/megakernel_scale_kmeans.cu``
    through :func:`scale_kmeans`, for models within the kernel's limits
    (:data:`KMEANS_MAX_K`, :data:`KMEANS_MAX_DIM`);

- ``("sparse_idf",)`` — IDF alone on a SparseVector column, the sparse
  kernel in its head-less mode (tf-idf values only) through :func:`sparse_idf`;

- every other chain without an MLP head: ``csrc/megakernel_rowlocal.cu``
  through :func:`rowlocal_chain`, which composes the chain from an op table
  (``csrc/rowlocal_ops.cuh``) — the row-local ops scale, normalize,
  elementwise_product, idf, binarize and impute, the dense ``logistic`` and
  ``kmeans`` heads, and the sparse ``sparse_idf`` and ``sparse_logistic``
  ops, in any order: for example ``("normalize", "kmeans")``, ``("sparse_idf",
  "sparse_logistic", "scale")`` (both calling conventions in one table: a
  sparse column is three slots, values f32, ids and nnz int32),
  ``("sparse_idf", "sparse_idf")`` or ``("kmeans", "binarize")`` on the
  kmeans index (an int32 slot; binarize keeps its dtype);
- every chain with one or more MLP heads: ``csrc/megakernel_scale_mlp.cu``
  through :func:`rowlocal_mlp`, the MLP kernel running the same table in
  phases — the ops before a head are its prologue, the ops after the last
  head its epilogue — for example ``("mlp",)``, ``("normalize", "mlp")``,
  ``("mlp", "scale")``, ``("normalize", "mlp", "binarize")`` on
  rawPrediction or ``("mlp", "mlp")``.

No chain the JAX package lowers as one megakernel stays on the merged
program, except those past a kernel's limits, which the merged program runs
in fast mode: a model vector of a dense op wider than
:data:`ROWLOCAL_MAX_DIM` (1024), a batch column of more (a sparse column's nnz
cap of more, checked per key by :func:`inputs_fit`), more than
:data:`ROWLOCAL_MAX_OPS` ops or :data:`ROWLOCAL_MAX_SLOTS` slots, a KMeans
model past :data:`KMEANS_MAX_K` centroids of :data:`KMEANS_MAX_DIM` features
or more centroids in all than :data:`ROWLOCAL_MAX_NORM_FLOATS` (with an MLP
head, :data:`MLP_MAX_NORM_FLOATS`), a network past :data:`MLP_MAX_LAYERS`,
:data:`MLP_MAX_WIDTH` or :data:`MLP_MAX_CLASSES`, more than
:data:`MLP_MAX_HEADS` MLP heads. The JAX package also admits chains its own
kernel cannot run — an op other than binarize or impute reading a head's
prediction or a kmeans index, which are [rows], where the op needs [rows,
width] (``("kmeans", "scale")`` on the index broadcasts to [1, rows] and the
Pallas kernel fails); the port refuses those.

Each wrapper chooses by the device of its input: tensors on the CPU take the
plain version — the same chain composed from ``ops/kernels.py`` — and CUDA
tensors launch the kernel or raise. There is no fallback from a failed build
or launch to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.native import CudaKernel, check_tensor as _check
from flink_ml_tpu_torch.ops.kernels import (
    binarize_fn,
    dot_fn,
    elementwise_product_fn,
    idf_scale_fn,
    impute_fn,
    kmeans_assign_fn,
    logistic_from_dots_fn,
    mlp_predict_fn,
    normalize_fn,
    scale_fn,
    sparse_dot_fn,
    sparse_idf_scale_fn,
)
from flink_ml_tpu_torch.servable.sparse import sparse_names

__all__ = [
    "KMEANS_MAX_DIM",
    "KMEANS_MAX_K",
    "KMEANS_MEASURES",
    "MEGAKERNEL_CHAINS",
    "MLP_MAX_CLASSES",
    "MLP_MAX_HEADS",
    "MLP_MAX_LAYERS",
    "MLP_MAX_NORM_FLOATS",
    "MLP_MAX_WIDTH",
    "ROWLOCAL",
    "ROWLOCAL_MAX_DIM",
    "ROWLOCAL_MAX_NORM_FLOATS",
    "ROWLOCAL_MAX_OPS",
    "ROWLOCAL_MAX_SLOTS",
    "ROWLOCAL_MLP",
    "ROWLOCAL_OPS",
    "RowLocalOp",
    "SCALE_KMEANS",
    "SCALE_LOGISTIC",
    "SPARSE_IDF_LOGISTIC",
    "SPARSE_OPS",
    "TABLE_OPS",
    "build_megakernel_fn",
    "chain_eligible",
    "inputs_fit",
    "rowlocal_chain",
    "rowlocal_chain_plain",
    "rowlocal_mlp",
    "rowlocal_mlp_plain",
    "scale_kmeans",
    "scale_kmeans_plain",
    "scale_logistic",
    "scale_logistic_path",
    "scale_logistic_plain",
    "sparse_idf",
    "sparse_idf_logistic",
    "sparse_idf_logistic_plain",
    "sparse_idf_plain",
]

#: Fusion-op chains with a kernel written for each.
MEGAKERNEL_CHAINS = frozenset({
    ("scale", "logistic"),
    ("logistic",),
    ("sparse_idf", "sparse_logistic"),
    ("sparse_logistic",),
    ("scale", "kmeans"),
    ("kmeans",),
})

#: The MLP networks ``csrc/megakernel_scale_mlp.cu`` holds (its kMaxHeads
#: heads in a table, each of kMaxLayers layers, kMaxWidth and kMaxClasses),
#: and the centroids its table's kmeans ops may hold in all (kMaxNormFloats:
#: their norms share the block's shared memory with the activations).
MLP_MAX_HEADS = 4
MLP_MAX_LAYERS = 8
MLP_MAX_WIDTH = 512
MLP_MAX_CLASSES = 32
MLP_MAX_NORM_FLOATS = 16 * 1024

#: The KMeans models ``csrc/megakernel_scale_kmeans.cu`` holds (its kMaxK and
#: kMaxDim), and its measure flags.
KMEANS_MAX_K = 1024
KMEANS_MAX_DIM = 1024
KMEANS_MEASURES = {"euclidean": 0, "manhattan": 1, "cosine": 2}

#: The ops of ``csrc/rowlocal_ops.cuh``'s table: the row-local ops, the dense
#: ``logistic`` and ``kmeans`` heads, the sparse ops (:data:`SPARSE_OPS`) and
#: the ``mlp`` head (the MLP kernel's) — every op of the JAX package's
#: ``MEGAKERNEL_OPS``, in any order. The table's limits: a lane's slots of a
#: row (kMaxDim: a width, a sparse column's nnz cap), the op table (kMaxOps)
#: and the slot table (kMaxSlots) in the kernel's parameters, and the
#: centroids the table's kmeans ops may hold in all
#: (``csrc/megakernel_rowlocal.cu`` kMaxNormFloats, their norms in the
#: block's shared memory).
ROWLOCAL_OPS = frozenset({"scale", "normalize", "elementwise_product", "idf", "binarize", "impute"})
SPARSE_OPS = frozenset({"sparse_idf", "sparse_logistic"})
TABLE_OPS = ROWLOCAL_OPS | SPARSE_OPS | {"logistic", "kmeans", "mlp"}
ROWLOCAL_MAX_DIM = 1024
ROWLOCAL_MAX_OPS = 32
ROWLOCAL_MAX_SLOTS = 64
ROWLOCAL_MAX_NORM_FLOATS = 48 * 1024

SCALE_LOGISTIC = CudaKernel(
    name="megakernel_scale_logistic",
    source="megakernel_scale_logistic.cu",
    symbol="megakernel_scale_logistic",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)

SPARSE_IDF_LOGISTIC = CudaKernel(
    name="megakernel_sparse_idf_logistic",
    source="megakernel_sparse_idf_logistic.cu",
    symbol="megakernel_sparse_idf_logistic",
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


SCALE_KMEANS = CudaKernel(
    name="megakernel_scale_kmeans",
    source="megakernel_scale_kmeans.cu",
    symbol="megakernel_scale_kmeans",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


ROWLOCAL = CudaKernel(
    name="megakernel_rowlocal",
    source="megakernel_rowlocal.cu",
    symbol="megakernel_rowlocal",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


ROWLOCAL_MLP = CudaKernel(
    name="megakernel_rowlocal_mlp",
    source="megakernel_scale_mlp.cu",
    symbol="megakernel_rowlocal_mlp",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


def _vector_width(arr: Any) -> Optional[int]:
    a = np.asarray(arr)
    return int(a.shape[0]) if a.ndim == 1 else None


def _head_width(head: Any, kind: str) -> Optional[int]:
    """The coefficient width of a logistic head reading one ``kind`` column
    into two outputs, or None when the head is not of that form."""
    if len(head.input_cols) != 1 or head.input_kind(head.input_cols[0]) != kind:
        return None
    if set(head.model_arrays) != {"coefficient"} or len(head.output_names) != 2:
        return None
    return _vector_width(head.model_arrays["coefficient"])


def _mlp_widths(head: Any) -> Optional[List[int]]:
    """The widths ``[d_in, hidden..., classes]`` of an MLP head reading one
    vector column into two outputs and holding ``W{i}``/``b{i}``/``labels``
    whose widths chain up, or None when the head is not of that form or the
    kernel cannot hold the network."""
    if len(head.input_cols) != 1 or head.input_kind(head.input_cols[0]) != "vector":
        return None
    arrays = head.model_arrays
    n = 0
    while f"W{n}" in arrays:
        n += 1
    names = {"labels", *(f"W{i}" for i in range(n)), *(f"b{i}" for i in range(n))}
    if len(head.output_names) != 2 or not 1 <= n <= MLP_MAX_LAYERS or set(arrays) != names:
        return None
    Ws = [np.asarray(arrays[f"W{i}"]) for i in range(n)]
    if any(W.ndim != 2 for W in Ws):
        return None
    widths = [int(Ws[0].shape[0])] + [int(W.shape[1]) for W in Ws]
    if any(W.shape[0] != widths[i] or _vector_width(arrays[f"b{i}"]) != widths[i + 1]
           for i, W in enumerate(Ws)):
        return None
    if _vector_width(arrays["labels"]) != widths[-1]:
        return None
    if not all(1 <= w <= MLP_MAX_WIDTH for w in widths) or widths[-1] > MLP_MAX_CLASSES:
        return None
    return widths


def _kmeans_width(head: Any) -> Optional[int]:
    """The feature width of a KMeans head reading one vector column into one
    output, holding ``centroids [k, d]`` within the kernel's limits and
    naming a measure the kernel has, or None."""
    if len(head.input_cols) != 1 or head.input_kind(head.input_cols[0]) != "vector":
        return None
    if set(head.model_arrays) != {"centroids"} or len(head.output_names) != 1:
        return None
    if head.fusion_params.get("distance_measure") not in KMEANS_MEASURES:
        return None
    centroids = np.asarray(head.model_arrays["centroids"])
    if centroids.ndim != 2:
        return None
    k, d = (int(s) for s in centroids.shape)
    if not (1 <= k <= KMEANS_MAX_K and 1 <= d <= KMEANS_MAX_DIM):
        return None
    return d


def chain_eligible(specs: Sequence[Any]) -> bool:
    """Whether this spec run has a megakernel. A chain of
    :data:`MEGAKERNEL_CHAINS` runs on its own kernel when it is of that
    kernel's form (:func:`_dedicated_eligible`); ``("sparse_idf",)`` on the
    sparse kernel's head-less mode (:func:`_sparse_idf_width`); any other
    chain of :data:`TABLE_OPS` on the row-local kernel, or with an MLP head
    on the MLP kernel, when every spec is of its form and the table within
    the kernels' limits (:func:`_rowlocal_program`)."""
    return _route(specs) is not None


def _route(specs: Sequence[Any]) -> Optional[str]:
    """Which kernel runs ``specs``: ``"dedicated"``, ``"sparse_idf"``,
    ``"table"`` (the row-local kernel or the MLP kernel), or None."""
    specs = tuple(specs)
    ops = tuple(getattr(s, "fusion_op", None) for s in specs)
    if ops in MEGAKERNEL_CHAINS and _dedicated_eligible(specs, ops):
        return "dedicated"
    if ops == ("sparse_idf",) and _sparse_idf_width(specs[0]) is not None:
        return "sparse_idf"
    return "table" if _rowlocal_program(specs) is not None else None


def inputs_fit(specs: Sequence[Any], inputs: Mapping[str, torch.Tensor]) -> bool:
    """Whether a batch's program ``inputs`` fit the kernel of an eligible
    chain: the table kernels take [rows] or [rows, width] columns of width
    ≤ :data:`ROWLOCAL_MAX_DIM` — a sparse column's values and ids of that
    nnz cap — and [rows, width] ones where an op needs them, which only the
    batch shows (a normalize or binarize spec carries no width, a sparse
    column no cap); the dedicated kernels' widths are fixed by their model
    arrays, checked by :func:`chain_eligible`."""
    if _route(specs) != "table":
        return True
    matrices = _rowlocal_program(specs).matrices
    return all((t.dim() == 1 and name not in matrices)
               or (t.dim() == 2 and 1 <= t.shape[1] <= ROWLOCAL_MAX_DIM)
               for name, t in inputs.items())


def _dedicated_eligible(specs: Sequence[Any], ops: Tuple[Any, ...]) -> bool:
    """A chain of :data:`MEGAKERNEL_CHAINS` on its kernel: the head reads one
    column (dense, or sparse for the sparse chains) and holds one
    coefficient vector, or, for KMeans, centroids the kernel can hold
    (:func:`_kmeans_width`); and a leading stage feeds the head's input
    column with vectors of the head's input width — mean / inv_std for the
    scaler, idf for the sparse IDF, whose output is the sparse column the
    head reads."""
    head = specs[-1]
    sparse = ops[-1] == "sparse_logistic"
    if ops[-1] == "kmeans":
        d = _kmeans_width(head)
    else:
        d = _head_width(head, "sparse" if sparse else "vector")
    if d is None:
        return False
    if len(specs) == 1:
        return True
    lead = specs[0]
    if lead.output_names != head.input_cols or len(lead.input_cols) != 1:
        return False
    if sparse:
        return (
            lead.input_kind(lead.input_cols[0]) == "sparse"
            and set(lead.model_arrays) == {"idf"}
            and _vector_width(lead.model_arrays["idf"]) == d
            and lead.sparse_outputs == {head.input_cols[0]: d}
        )
    return (
        set(lead.model_arrays) == {"mean", "inv_std"}
        and all(_vector_width(a) == d for a in lead.model_arrays.values())
        and set(lead.fusion_params) == {"with_mean", "with_std"}
    )


def _sparse_idf_width(spec: Any) -> Optional[int]:
    """The width of an IDF spec in the sparse convention — one sparse column
    in, one sparse column of the idf's width out — or None."""
    if len(spec.input_cols) != 1 or spec.input_kind(spec.input_cols[0]) != "sparse":
        return None
    if set(spec.model_arrays) != {"idf"} or len(spec.output_names) != 1:
        return None
    d = _vector_width(spec.model_arrays["idf"])
    if d is None or spec.sparse_outputs != {spec.output_names[0]: d}:
        return None
    return d


class _Binding(NamedTuple):
    """One table entry of a spec before its model tensors are known: the op,
    the program name it reads (``src``; a sparse op's values) and, for a
    sparse op, its ids; the names of its new output slots (``out``: one, or
    a head's prediction and rawPrediction); the outputs that are the inputs
    themselves (``aliases``: a sparse IDF's ids and nnz, ``(output, input)``);
    the names of the spec's model arrays it reads (``a``, ``b``); its static
    parameters; and the input width the entry needs (None: any)."""

    op: str
    src: str
    ids: Optional[str]
    out: Tuple[str, ...]
    aliases: Tuple[Tuple[str, str], ...]
    a: Optional[str]
    b: Optional[str]
    params: Mapping[str, Any]
    width: Optional[int]


class _OpTemplate(NamedTuple):
    """One op of a table chain: the op, its input slot, the spec it comes
    from, the names of that spec's model arrays it reads (``a``, ``b``) and
    its static parameters (a sparse op's ``ids`` slot; an MLP head's
    ``n_layers``)."""

    op: str
    src: int
    spec: int
    a: Optional[str]
    b: Optional[str]
    params: Mapping[str, Any]


class _RowLocalProgram(NamedTuple):
    inputs: Tuple[str, ...]  # the chain's program inputs: slots 0..m-1
    ops: Tuple[_OpTemplate, ...]
    outputs: Tuple[Tuple[str, int], ...]  # every program output and its slot, the last writer's
    matrices: frozenset  # the program inputs that must be [rows, width]
    mlp_heads: int

    def bind(self, models: Sequence[Mapping[str, torch.Tensor]],
             cols: Mapping[str, torch.Tensor]) -> Tuple[List[torch.Tensor], List["RowLocalOp"]]:
        """The table kernels' arguments for one call: the program inputs from
        ``cols`` in slot order, and the ops on ``models``' tensors."""
        ops = []
        for t in self.ops:
            m = models[t.spec]
            layers = [(m[f"W{i}"], m[f"b{i}"]) for i in range(t.params["n_layers"])] if t.op == "mlp" else ()
            ops.append(RowLocalOp(t.op, t.src, m.get(t.a), m.get(t.b), t.params, layers))
        return [cols[name] for name in self.inputs], ops


def _is_rowlocal_vector(spec: Any, key: str) -> bool:
    a = np.asarray(spec.model_arrays[key])
    return a.ndim == 1 and 1 <= a.shape[0] <= ROWLOCAL_MAX_DIM


def _rowlocal_bindings(spec: Any) -> Optional[List[_Binding]]:
    """The table entries of a :data:`TABLE_OPS` spec of its op's form (one
    per column for binarize and impute), or None when the spec is not of
    that form."""
    op, ins, outs = spec.fusion_op, spec.input_cols, spec.output_names
    arrays, params = set(spec.model_arrays), spec.fusion_params
    if op in SPARSE_OPS:
        if op == "sparse_idf":
            d = _sparse_idf_width(spec)
            if d is None:
                return None
            (i,), (o,) = ins, outs
            (iv, ii, iz), (ov, oi, oz) = sparse_names(i), sparse_names(o)
            return [_Binding(op, iv, ii, (ov,), ((oi, ii), (oz, iz)), "idf", None, {}, None)]
        d = _head_width(spec, "sparse")
        if d is None or not 0 < d < 2**31:
            return None
        iv, ii, _iz = sparse_names(ins[0])
        return [_Binding(op, iv, ii, tuple(outs), (), "coefficient", None, {}, None)]
    if any(spec.input_kind(c) not in ("vector", "dense", "scalar") for c in ins):
        return None
    if op == "mlp":
        widths = _mlp_widths(spec)
        if widths is None:
            return None
        return [_Binding(op, ins[0], None, tuple(outs), (), "labels", None,
                         {"n_layers": len(widths) - 1, "classes": widths[-1]}, widths[0])]
    if op == "logistic":
        d = _head_width(spec, "vector")
        if d is None or not 1 <= d <= ROWLOCAL_MAX_DIM:
            return None
        return [_Binding(op, ins[0], None, tuple(outs), (), "coefficient", None, {}, d)]
    if op == "kmeans":
        d = _kmeans_width(spec)
        if d is None:
            return None
        return [_Binding(op, ins[0], None, tuple(outs), (), "centroids", None,
                         {"measure": params["distance_measure"]}, d)]
    if op in ("binarize", "impute"):
        if not ins or len(ins) != len(outs):
            return None
        if op == "binarize":
            t = params.get("thresholds")
            if arrays or set(params) != {"thresholds"} or t is None or len(t) != len(ins):
                return None
            return [_Binding(op, i, None, (o,), (), None, None, {"threshold": float(th)}, None)
                    for i, o, th in zip(ins, outs, t)]
        if arrays != {"surrogates"} or set(params) != {"missing_is_nan", "missing_value"}:
            return None
        if np.asarray(spec.model_arrays["surrogates"]).shape != (len(ins),):
            return None
        return [_Binding(op, i, None, (o,), (), "surrogates", None,
                         {"missing_is_nan": bool(params["missing_is_nan"]),
                          "missing_value": float(params["missing_value"]), "column": k}, None)
                for k, (i, o) in enumerate(zip(ins, outs))]
    if len(ins) != 1 or len(outs) != 1:
        return None
    (i,), (o,) = ins, outs
    if op == "scale":
        if arrays != {"mean", "inv_std"} or set(params) != {"with_mean", "with_std"}:
            return None
        if not (_is_rowlocal_vector(spec, "mean") and _is_rowlocal_vector(spec, "inv_std")):
            return None
        d = _vector_width(spec.model_arrays["mean"])
        if _vector_width(spec.model_arrays["inv_std"]) != d:
            return None
        return [_Binding(op, i, None, (o,), (), "mean", "inv_std",
                         {"with_mean": bool(params["with_mean"]), "with_std": bool(params["with_std"])}, d)]
    if op == "normalize":
        if arrays or set(params) != {"p"} or not float(params["p"]) >= 1.0:
            return None
        return [_Binding(op, i, None, (o,), (), None, None, {"p": float(params["p"])}, None)]
    if op in ("elementwise_product", "idf"):
        key = "scaling" if op == "elementwise_product" else "idf"
        if arrays != {key} or params or not _is_rowlocal_vector(spec, key):
            return None
        return [_Binding(op, i, None, (o,), (), key, None, {}, _vector_width(spec.model_arrays[key]))]
    return None


def _rowlocal_program(specs: Sequence[Any]) -> Optional[_RowLocalProgram]:
    """The table for ``specs``, or None when the chain is not of its form:
    every spec a :data:`TABLE_OPS` op of its form (:func:`_rowlocal_bindings`)
    over dense, scalar or sparse columns; every op but binarize and impute
    reading a [rows, width] column (not a head's prediction or a kmeans
    index, which are [rows]); the widths the model arrays fix agreeing; and
    the table within the kernels' limits (:data:`ROWLOCAL_MAX_OPS`,
    :data:`ROWLOCAL_MAX_SLOTS`, :data:`MLP_MAX_HEADS`, and the centroids its
    kmeans ops hold in all).

    Slots: the chain's program inputs first, then each op's outputs in
    order. A spec's ops read the columns as they stood before the spec (as
    its ``kernel_fn`` does), and a column written twice names its last
    slot, as the chain's ``cols.update`` leaves it. A sparse IDF's ids and
    nnz outputs name its input's slots."""
    specs = tuple(specs)
    if not specs:
        return None
    bindings = []
    for spec in specs:
        if getattr(spec, "fusion_op", None) not in TABLE_OPS:
            return None
        b = _rowlocal_bindings(spec)
        if b is None:
            return None
        bindings.append(b)
    produced: set = set()
    inputs: List[str] = []
    for spec, b in zip(specs, bindings):
        for e in b:
            for name in (e.src, e.ids, *(i for _o, i in e.aliases)):
                if name is not None and name not in produced and name not in inputs:
                    inputs.append(name)
        produced.update(spec.program_outputs)
    slot = {name: k for k, name in enumerate(inputs)}
    n_slots = len(inputs)
    width: Dict[str, int] = {}  # a column's width where a model array fixes it
    flat = {n for s in specs for n in s.input_cols if s.input_kind(n) == "scalar"}  # [rows] columns
    matrices: set = set()
    ops: List[_OpTemplate] = []
    outputs: Dict[str, int] = {}

    def reads(col: str, need: Optional[int], matrix: bool) -> bool:
        if matrix:
            if col in flat:
                return False
            if col in inputs:
                matrices.add(col)
        if need is not None and width.setdefault(col, need) != need:
            return False
        return True

    for si, (spec, b) in enumerate(zip(specs, bindings)):
        srcs = [(slot[e.src], None if e.ids is None else slot[e.ids]) for e in b]  # read before this spec writes
        for e in b:
            if not reads(e.src, e.width, e.op not in ("binarize", "impute")):
                return None
            if e.ids is not None:
                matrices.update(n for n in (e.src, e.ids) if n in inputs)
        state = [(width.get(e.src), e.src in flat) for e in b]
        aliased = {o: slot[i] for e in b for o, i in e.aliases}
        for (src, ids), (w_in, flat_in), e in zip(srcs, state, b):
            params = dict(e.params)
            if ids is not None:
                params["ids"] = ids
            ops.append(_OpTemplate(e.op, src, si, e.a, e.b, params))
            for name in e.out:
                slot[name] = outputs[name] = n_slots
                n_slots += 1
                width.pop(name, None)
                flat.discard(name)
            if e.op in ("logistic", "sparse_logistic", "kmeans", "mlp"):  # heads: prediction is [rows]
                flat.add(e.out[0])
                if e.op != "kmeans":
                    width[e.out[1]] = e.params.get("classes", 2)
            elif e.op != "sparse_idf":  # an elementwise op keeps its input's shape
                (o,) = e.out
                if w_in is not None:
                    width[o] = w_in
                if flat_in:
                    flat.add(o)
        for name, k in aliased.items():  # no dense op reads a sparse column's parts
            slot[name] = outputs[name] = k
    if set(outputs) != {name for spec in specs for name in spec.program_outputs}:
        return None
    mlp_heads = sum(1 for t in ops if t.op == "mlp")
    centroids = sum(int(np.asarray(spec.model_arrays["centroids"]).shape[0])
                    for spec in specs if spec.fusion_op == "kmeans")
    norm_budget = MLP_MAX_NORM_FLOATS if mlp_heads else ROWLOCAL_MAX_NORM_FLOATS
    if (len(ops) > ROWLOCAL_MAX_OPS or n_slots > ROWLOCAL_MAX_SLOTS or mlp_heads > MLP_MAX_HEADS
            or centroids > norm_budget):
        return None
    return _RowLocalProgram(tuple(inputs), tuple(ops), tuple(outputs.items()), frozenset(matrices),
                            mlp_heads)


# ---------------------------------------------------------------------------
# scale → logistic (dense)
# ---------------------------------------------------------------------------


def scale_logistic_plain(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    coef: torch.Tensor,
    *,
    with_mean: bool,
    with_std: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch: ``(scaled, prediction, rawPrediction)``."""
    scaled = scale_fn(x, mean, inv_std, with_mean=with_mean, with_std=with_std)
    pred, raw = logistic_from_dots_fn(dot_fn(scaled, coef))
    return scaled, pred, raw


def scale_logistic_path(x: torch.Tensor, *others: Optional[torch.Tensor]) -> str:
    """The path the kernel's entry point takes for ``x`` [rows, d] and the
    other tensors it reads or writes (None: not in use), for reports:
    ``"16-byte"`` when d is a multiple of 4 and every tensor starts on a
    16-byte boundary, so rows load and store as float4; ``"scalar"``
    otherwise (any d, any offset of a contiguous view)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others) if t is not None)
    return "16-byte" if aligned and x.shape[-1] % 4 == 0 else "scalar"


def scale_logistic(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    coef: torch.Tensor,
    *,
    with_mean: bool,
    with_std: bool,
    write_scaled: bool,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(scaled or None, prediction [rows], rawPrediction [rows, 2])`` for
    ``x`` [rows, d]. CPU tensors run the plain version; CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise; the
    kernel picks the path that :func:`scale_logistic_path` reports."""
    if x.device.type == "cpu":
        scaled, pred, raw = scale_logistic_plain(
            x, mean, inv_std, coef, with_mean=with_mean, with_std=with_std
        )
        return (scaled if write_scaled else None), pred, raw
    if x.device.type != "cuda":
        raise RuntimeError(f"{SCALE_LOGISTIC.name} needs CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, d], got shape {tuple(x.shape)}")
    rows, d = (int(s) for s in x.shape)
    device = x.device
    _check("x", x, (rows, d), device)
    _check("coef", coef, (d,), device)
    if with_mean:
        _check("mean", mean, (d,), device)
    if with_std:
        _check("inv_std", inv_std, (d,), device)
    scaled = torch.empty((rows, d), dtype=torch.float32, device=device) if write_scaled else None
    pred = torch.empty((rows,), dtype=torch.float32, device=device)
    raw = torch.empty((rows, 2), dtype=torch.float32, device=device)
    if rows:
        with torch.cuda.device(device):
            SCALE_LOGISTIC.launch(
                x.data_ptr(),
                mean.data_ptr() if with_mean else None,
                inv_std.data_ptr() if with_std else None,
                coef.data_ptr(),
                scaled.data_ptr() if write_scaled else None,
                pred.data_ptr(),
                raw.data_ptr(),
                rows, d, int(with_mean), int(with_std), int(write_scaled),
                torch.cuda.current_stream(device).cuda_stream,
            )
    return scaled, pred, raw


# ---------------------------------------------------------------------------
# sparse_idf → sparse_logistic (the sparse calling convention)
# ---------------------------------------------------------------------------


def sparse_idf_logistic_plain(
    values: torch.Tensor,
    ids: torch.Tensor,
    idf: Optional[torch.Tensor],
    coef: torch.Tensor,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch: ``(tfidf or None, margin, prediction,
    rawPrediction)``; without ``idf`` the head reads ``values`` directly."""
    tfidf = None if idf is None else sparse_idf_scale_fn(values, ids, idf)
    margin = sparse_dot_fn(values if tfidf is None else tfidf, ids, coef)
    pred, raw = logistic_from_dots_fn(margin)
    return tfidf, margin, pred, raw


def sparse_idf_logistic(
    values: torch.Tensor,
    ids: torch.Tensor,
    idf: Optional[torch.Tensor],
    coef: torch.Tensor,
    *,
    write_tfidf: bool,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(tfidf [rows, K] or None, margin [rows], prediction [rows],
    rawPrediction [rows, 2])`` for a packed sparse column ``values`` f32 /
    ``ids`` i32 [rows, K]. ``idf`` None runs the head alone; ``write_tfidf``
    (with ``idf``) keeps the IDF stage's output. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream (no
    synchronisation) or raise."""
    if write_tfidf and idf is None:
        raise ValueError("write_tfidf needs the idf vector")
    if values.device.type == "cpu":
        tfidf, margin, pred, raw = sparse_idf_logistic_plain(values, ids, idf, coef)
        return (tfidf if write_tfidf else None), margin, pred, raw
    if values.device.type != "cuda":
        raise RuntimeError(
            f"{SPARSE_IDF_LOGISTIC.name} needs CPU or CUDA tensors, got {values.device}"
        )
    if values.dim() != 2:
        raise ValueError(f"values must be [rows, K], got shape {tuple(values.shape)}")
    rows, K = (int(s) for s in values.shape)
    d = int(coef.shape[0]) if coef.dim() == 1 else -1
    if K < 1 or not 0 < d < 2**31:
        raise ValueError(f"needs K >= 1 and 0 < d < 2^31, got K={K}, coef shape {tuple(coef.shape)}")
    device = values.device
    _check("values", values, (rows, K), device)
    _check("ids", ids, (rows, K), device, torch.int32)
    _check("coef", coef, (d,), device)
    if idf is not None:
        _check("idf", idf, (d,), device)
    tfidf = torch.empty((rows, K), dtype=torch.float32, device=device) if write_tfidf else None
    margin = torch.empty((rows,), dtype=torch.float32, device=device)
    pred = torch.empty((rows,), dtype=torch.float32, device=device)
    raw = torch.empty((rows, 2), dtype=torch.float32, device=device)
    if rows:
        with torch.cuda.device(device):
            SPARSE_IDF_LOGISTIC.launch(
                values.data_ptr(),
                ids.data_ptr(),
                idf.data_ptr() if idf is not None else None,
                coef.data_ptr(),
                tfidf.data_ptr() if write_tfidf else None,
                margin.data_ptr(),
                pred.data_ptr(),
                raw.data_ptr(),
                rows, K, d, int(idf is not None), int(write_tfidf), 1,
                torch.cuda.current_stream(device).cuda_stream,
            )
    return tfidf, margin, pred, raw


def sparse_idf_plain(values: torch.Tensor, ids: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """IDF alone in plain PyTorch: ``sparse_idf_scale_fn``."""
    return sparse_idf_scale_fn(values, ids, idf)


def sparse_idf(values: torch.Tensor, ids: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """The tf-idf values [rows, K] of a packed sparse column ``values`` f32 /
    ``ids`` i32 [rows, K]: ``values * idf[ids]``, each product rounded once
    (bit-equal to the plain version). CPU tensors run the plain version;
    CUDA tensors launch the sparse kernel in its head-less mode on the
    current stream (no synchronisation) or raise."""
    if values.device.type == "cpu":
        return sparse_idf_plain(values, ids, idf)
    if values.device.type != "cuda":
        raise RuntimeError(
            f"{SPARSE_IDF_LOGISTIC.name} needs CPU or CUDA tensors, got {values.device}"
        )
    if values.dim() != 2 or idf.dim() != 1:
        raise ValueError(f"values must be [rows, K] and idf [d], got shapes "
                         f"{tuple(values.shape)} and {tuple(idf.shape)}")
    rows, K = (int(s) for s in values.shape)
    d = int(idf.shape[0])
    if K < 1 or not 0 < d < 2**31:
        raise ValueError(f"needs K >= 1 and 0 < d < 2^31, got K={K}, idf shape {tuple(idf.shape)}")
    device = values.device
    _check("values", values, (rows, K), device)
    _check("ids", ids, (rows, K), device, torch.int32)
    _check("idf", idf, (d,), device)
    tfidf = torch.empty((rows, K), dtype=torch.float32, device=device)
    if rows:
        with torch.cuda.device(device):
            SPARSE_IDF_LOGISTIC.launch(
                values.data_ptr(), ids.data_ptr(), idf.data_ptr(), None,
                tfidf.data_ptr(), None, None, None,
                rows, K, d, 1, 1, 0,
                torch.cuda.current_stream(device).cuda_stream,
            )
    return tfidf


# ---------------------------------------------------------------------------
# scale → kmeans (dense)
# ---------------------------------------------------------------------------


def scale_kmeans_plain(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    centroids: torch.Tensor,
    *,
    measure: str,
    with_mean: bool,
    with_std: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch: ``(scaled, prediction)`` — ``scale_fn``
    and ``kmeans_assign_fn``, the index as int32 as the kernel writes it."""
    scaled = scale_fn(x, mean, inv_std, with_mean=with_mean, with_std=with_std)
    return scaled, kmeans_assign_fn(measure)(scaled, centroids).to(torch.int32)


def scale_kmeans(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    centroids: torch.Tensor,
    *,
    measure: str,
    with_mean: bool,
    with_std: bool,
    write_scaled: bool,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """``(scaled or None, prediction [rows] int32)`` for ``x`` [rows, d]: the
    index of the closest of ``centroids`` [k, d] under ``measure``. CPU
    tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (no synchronisation) or raise — also for a model past the
    kernel's limits."""
    if measure not in KMEANS_MEASURES:
        raise ValueError(f"{SCALE_KMEANS.name} has measures {sorted(KMEANS_MEASURES)}, got {measure!r}")
    if x.device.type == "cpu":
        scaled, pred = scale_kmeans_plain(
            x, mean, inv_std, centroids, measure=measure, with_mean=with_mean, with_std=with_std
        )
        return (scaled if write_scaled else None), pred
    if x.device.type != "cuda":
        raise RuntimeError(f"{SCALE_KMEANS.name} needs CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2 or centroids.dim() != 2:
        raise ValueError(f"x must be [rows, d] and centroids [k, d], got shapes "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    rows, d = (int(s) for s in x.shape)
    k = int(centroids.shape[0])
    if not (1 <= k <= KMEANS_MAX_K and 1 <= d <= KMEANS_MAX_DIM):
        raise ValueError(
            f"{SCALE_KMEANS.name} holds 1-{KMEANS_MAX_K} centroids of 1-{KMEANS_MAX_DIM} "
            f"features; got k={k}, d={d}"
        )
    device = x.device
    _check("x", x, (rows, d), device)
    _check("centroids", centroids, (k, d), device)
    if with_mean:
        _check("mean", mean, (d,), device)
    if with_std:
        _check("inv_std", inv_std, (d,), device)
    scaled = torch.empty((rows, d), dtype=torch.float32, device=device) if write_scaled else None
    pred = torch.empty((rows,), dtype=torch.int32, device=device)
    if rows:
        with torch.cuda.device(device):
            SCALE_KMEANS.launch(
                x.data_ptr(),
                mean.data_ptr() if with_mean else None,
                inv_std.data_ptr() if with_std else None,
                centroids.data_ptr(),
                scaled.data_ptr() if write_scaled else None,
                pred.data_ptr(),
                rows, d, k, KMEANS_MEASURES[measure], int(with_mean), int(with_std),
                int(write_scaled),
                torch.cuda.current_stream(device).cuda_stream,
            )
    return scaled, pred


# ---------------------------------------------------------------------------
# table chains, composed from an op table
# ---------------------------------------------------------------------------


class RowLocalOp(NamedTuple):
    """One op of a table chain: ``op`` (a :data:`TABLE_OPS` op) reads slot
    ``src`` (a sparse op: the values slot); the model tensors ``a`` (scale's
    mean, the product's scaling, idf, impute's surrogates, the logistic
    head's coefficient, the kmeans head's centroids [k, width], the sparse
    ops' idf or coefficient [d], the MLP head's labels [classes]) and ``b``
    (scale's inv_std); ``params`` the static arguments (``with_mean``/
    ``with_std``; ``p``; ``threshold``; ``missing_is_nan``/``missing_value``
    and the surrogate's ``column``; the kmeans ``measure``; a sparse op's
    ``ids`` slot); ``layers`` the MLP head's ``(W [d_in, d_out], b
    [d_out])`` pairs. Slots: the chain's inputs, then each op's outputs in
    order — one (int32 indices for kmeans; binarize keeps its input's
    dtype), or ``prediction`` and ``rawPrediction`` for the heads (the MLP's
    probabilities [rows, classes])."""

    op: str
    src: int
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    params: Mapping[str, Any] = {}
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()


_ROWLOCAL_CODES = {"scale": 0, "normalize": 1, "elementwise_product": 2, "idf": 3,
                   "binarize": 4, "impute": 5, "logistic": 6, "kmeans": 7,
                   "sparse_idf": 8, "sparse_logistic": 9, "mlp": 10}
_HEADS = ("logistic", "sparse_logistic", "mlp")
_SLOT_DTYPES = {torch.float32: 0, torch.int32: 1}  # csrc/rowlocal_ops.cuh SlotType


class _Op(ctypes.Structure):  # csrc/rowlocal_ops.cuh Op
    _fields_ = [("op", ctypes.c_int), ("src", ctypes.c_int), ("dst", ctypes.c_int),
                ("dst2", ctypes.c_int), ("flags", ctypes.c_int), ("k", ctypes.c_int),
                ("s0", ctypes.c_float), ("s1", ctypes.c_float), ("a", ctypes.c_void_p),
                ("b", ctypes.c_void_p)]


class _Slot(ctypes.Structure):  # csrc/rowlocal_ops.cuh Slot
    _fields_ = [("ptr", ctypes.c_void_p), ("width", ctypes.c_int), ("dtype", ctypes.c_int)]


def rowlocal_chain_plain(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The chain in plain PyTorch, op by op through ``ops/kernels.py``:
    the output tensors in slot order. The plain version of both table
    kernels."""
    slots = list(inputs)
    for op in ops:
        x, p = slots[op.src], op.params
        if op.op == "scale":
            slots.append(scale_fn(x, op.a, op.b, with_mean=p["with_mean"], with_std=p["with_std"]))
        elif op.op == "normalize":
            slots.append(normalize_fn(x, p["p"]))
        elif op.op == "elementwise_product":
            slots.append(elementwise_product_fn(x, op.a))
        elif op.op == "idf":
            slots.append(idf_scale_fn(x, op.a))
        elif op.op == "binarize":
            slots.append(binarize_fn(x, p["threshold"]))
        elif op.op == "impute":
            slots.append(impute_fn(x, op.a[p["column"]], p["missing_is_nan"], p["missing_value"]))
        elif op.op == "logistic":
            slots.extend(logistic_from_dots_fn(dot_fn(x, op.a)))
        elif op.op == "kmeans":
            slots.append(kmeans_assign_fn(p["measure"])(x, op.a).to(torch.int32))
        elif op.op == "sparse_idf":
            slots.append(sparse_idf_scale_fn(x, slots[p["ids"]], op.a))
        elif op.op == "sparse_logistic":
            slots.extend(logistic_from_dots_fn(sparse_dot_fn(x, slots[p["ids"]], op.a)))
        elif op.op == "mlp":
            pred_idx, probs = mlp_predict_fn(op.layers, x)
            slots.extend([op.a[pred_idx.long()], probs])
        else:
            raise ValueError(f"{op.op!r} is no table op")
    return slots[len(inputs):]


def rowlocal_mlp_plain(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The plain version of the MLP kernel: the same interpreter as
    :func:`rowlocal_chain_plain`, on a table with one or more MLP heads."""
    return rowlocal_chain_plain(inputs, ops)


class _Launch(NamedTuple):
    """A table on CUDA tensors: the ctypes op and slot tables, every slot's
    tensor (the outputs allocated), the rows, and the MLP heads' networks
    (``weights``, ``biases``, ``widths``, ``n_layers`` as ctypes arrays)."""

    ops: Any
    slots: Any
    tensors: List[torch.Tensor]
    rows: int
    nets: Optional[Tuple[Any, Any, Any, Any]]


def _table(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp], kernel: CudaKernel) -> _Launch:
    """The ctypes tables of a chain on CUDA tensors, with the output tensors
    allocated. Raises for a table, a slot or a network past the kernel's
    limits or of the wrong form: the row-local kernel takes no MLP head, the
    MLP kernel 1 to :data:`MLP_MAX_HEADS`."""
    device = inputs[0].device
    rows = int(inputs[0].shape[0]) if inputs[0].dim() else -1
    n_slots = len(inputs) + sum(2 if op.op in _HEADS else 1 for op in ops)
    heads = sum(1 for op in ops if op.op == "mlp")
    min_heads, max_heads = (1, MLP_MAX_HEADS) if kernel is ROWLOCAL_MLP else (0, 0)
    if not 1 <= len(ops) <= ROWLOCAL_MAX_OPS or n_slots > ROWLOCAL_MAX_SLOTS \
            or not min_heads <= heads <= max_heads:
        raise ValueError(f"{kernel.name} holds 1-{ROWLOCAL_MAX_OPS} ops over at most "
                         f"{ROWLOCAL_MAX_SLOTS} slots with {min_heads}-{max_heads} MLP heads; got "
                         f"{len(ops)} ops, {n_slots} slots, {heads} MLP heads")
    slots: List[torch.Tensor] = []
    for k, t in enumerate(inputs):
        if t.dim() not in (1, 2) or not 1 <= (t.shape[1] if t.dim() == 2 else 1) <= ROWLOCAL_MAX_DIM:
            raise ValueError(f"{kernel.name} takes [rows] or [rows, 1-{ROWLOCAL_MAX_DIM}] "
                             f"columns; input {k} has shape {tuple(t.shape)}")
        if t.dtype not in _SLOT_DTYPES:
            raise TypeError(f"{kernel.name} takes float32 or int32 columns; input {k} is {t.dtype}")
        _check(f"input {k}", t, (rows,) + tuple(t.shape[1:]), device, t.dtype)
        slots.append(t)
    table = (_Op * len(ops))()
    weights: List[int] = []
    biases: List[int] = []
    widths: List[int] = []
    n_layers: List[int] = []
    for entry, op in zip(table, ops):
        if op.op not in _ROWLOCAL_CODES or not 0 <= op.src < len(slots):
            raise ValueError(f"{kernel.name}: op {op.op!r} reads slot {op.src} of {len(slots)}")
        x, p = slots[op.src], op.params
        if x.dtype != torch.float32 and op.op not in ("binarize", "impute"):
            raise ValueError(f"{kernel.name}: op {op.op!r} reads slot {op.src} of {x.dtype}")
        width = int(x.shape[1]) if x.dim() == 2 else 1
        needs_a = op.op not in ("normalize", "binarize") and not (op.op == "scale" and not p["with_mean"])
        if (needs_a and op.a is None) or (op.op == "scale" and p["with_std"] and op.b is None):
            raise ValueError(f"{kernel.name}: op {op.op!r} is missing its model tensor")
        entry.op, entry.src = _ROWLOCAL_CODES[op.op], op.src
        if op.op not in ("binarize", "impute") and x.dim() != 2:
            raise ValueError(f"{op.op} reads [rows, d] columns; slot {op.src} has shape {tuple(x.shape)}")
        if op.op in ("scale", "elementwise_product", "idf", "logistic"):
            if op.op != "scale" or p["with_mean"]:
                _check(f"{op.op} model vector", op.a, (width,), device)
                entry.a = op.a.data_ptr()
        if op.op == "scale":
            entry.flags = int(bool(p["with_mean"])) | 2 * int(bool(p["with_std"]))
            if p["with_std"]:
                _check("scale inv_std", op.b, (width,), device)
                entry.b = op.b.data_ptr()
        elif op.op == "normalize":
            if not float(p["p"]) >= 1.0:
                raise ValueError(f"normalize takes p >= 1; got p {p['p']}")
            entry.s0, entry.s1 = float(p["p"]), float(np.float32(1.0 / float(p["p"])))
        elif op.op == "binarize":
            entry.s0 = float(p["threshold"])
        elif op.op == "impute":
            _check("impute surrogates", op.a, (int(op.a.shape[0]),), device)
            if not 0 <= p["column"] < op.a.shape[0]:
                raise ValueError(f"impute column {p['column']} of {op.a.shape[0]} surrogates")
            entry.flags = int(bool(p["missing_is_nan"]))
            entry.s0 = float(p["missing_value"])
            entry.a = op.a.data_ptr() + 4 * int(p["column"])
        elif op.op == "kmeans":
            k = int(op.a.shape[0]) if op.a.dim() == 2 else -1
            if p.get("measure") not in KMEANS_MEASURES or not 1 <= k <= KMEANS_MAX_K:
                raise ValueError(f"kmeans takes 1-{KMEANS_MAX_K} centroids under "
                                 f"{sorted(KMEANS_MEASURES)}; got shape {tuple(op.a.shape)}, "
                                 f"measure {p.get('measure')!r}")
            _check("kmeans centroids", op.a, (k, width), device)
            entry.a, entry.k, entry.flags = op.a.data_ptr(), k, KMEANS_MEASURES[p["measure"]]
        elif op.op in ("sparse_idf", "sparse_logistic"):
            ids = p.get("ids", -1)
            if not 0 <= ids < len(slots):
                raise ValueError(f"{kernel.name}: op {op.op!r} reads ids slot {ids} of {len(slots)}")
            _check(f"{op.op} ids", slots[ids], tuple(x.shape), device, torch.int32)
            d = int(op.a.shape[0]) if op.a.dim() == 1 else -1
            if not 0 < d < 2**31:
                raise ValueError(f"{op.op} takes a model vector of 1 to 2^31 - 1 values; got shape "
                                 f"{tuple(op.a.shape)}")
            _check(f"{op.op} model vector", op.a, (d,), device)
            entry.a, entry.k, entry.flags = op.a.data_ptr(), ids, d
        elif op.op == "mlp":
            net = [width] + [int(W.shape[-1]) for W, _ in op.layers]
            if not 1 <= len(op.layers) <= MLP_MAX_LAYERS or not all(1 <= w <= MLP_MAX_WIDTH for w in net) \
                    or net[-1] > MLP_MAX_CLASSES:
                raise ValueError(
                    f"{kernel.name} holds 1-{MLP_MAX_LAYERS} layers of widths 1-{MLP_MAX_WIDTH} and "
                    f"at most {MLP_MAX_CLASSES} classes; got widths {net}"
                )
            for i, (W, b) in enumerate(op.layers):
                _check(f"W{i}", W, (net[i], net[i + 1]), device)
                _check(f"b{i}", b, (net[i + 1],), device)
                weights.append(W.data_ptr())
                biases.append(b.data_ptr())
            _check("labels", op.a, (net[-1],), device)
            entry.a, entry.k = op.a.data_ptr(), len(n_layers)
            widths.extend(net)
            n_layers.append(len(op.layers))
        if op.op in _HEADS:
            second = 2 if op.op != "mlp" else int(op.layers[-1][0].shape[-1])
            out = [torch.empty((rows,), dtype=torch.float32, device=device),
                   torch.empty((rows, second), dtype=torch.float32, device=device)]
            entry.dst, entry.dst2 = len(slots), len(slots) + 1
        else:
            if op.op == "kmeans":
                out = [torch.empty((rows,), dtype=torch.int32, device=device)]
            else:  # an elementwise op: its input's shape; binarize keeps its dtype
                dtype = x.dtype if op.op == "binarize" else torch.float32
                out = [torch.empty(tuple(x.shape), dtype=dtype, device=device)]
            entry.dst = entry.dst2 = len(slots)
        slots.extend(out)
    slot_table = (_Slot * len(slots))()
    for entry, t in zip(slot_table, slots):
        entry.ptr = t.data_ptr()
        entry.width = int(t.shape[1]) if t.dim() == 2 else 1
        entry.dtype = _SLOT_DTYPES[t.dtype]
    nets = None
    if n_layers:
        nets = ((ctypes.c_void_p * len(weights))(*weights), (ctypes.c_void_p * len(biases))(*biases),
                (ctypes.c_int * len(widths))(*widths), (ctypes.c_int * len(n_layers))(*n_layers))
    return _Launch(table, slot_table, slots, rows, nets)


def rowlocal_chain(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The outputs of ``ops`` (no MLP head) over ``inputs`` ([rows] or [rows,
    width] float32 or int32 columns), in slot order (:class:`RowLocalOp`):
    each elementwise op's output of its input's shape, the logistic heads'
    ``prediction [rows]`` and ``rawPrediction [rows, 2]``, the kmeans head's
    int32 index [rows], a sparse IDF's values of its input's shape. CPU
    tensors run the plain version; CUDA tensors launch the row-local kernel
    on the current stream (no synchronisation) or raise — also for a table
    or a width past the kernel's limits."""
    if not inputs:
        raise ValueError(f"{ROWLOCAL.name} needs at least one input column")
    device = inputs[0].device
    if device.type == "cpu":
        return rowlocal_chain_plain(inputs, ops)
    if device.type != "cuda":
        raise RuntimeError(f"{ROWLOCAL.name} needs CPU or CUDA tensors, got {device}")
    t = _table(inputs, ops, ROWLOCAL)
    if t.rows:
        with torch.cuda.device(device):
            ROWLOCAL.launch(ctypes.addressof(t.ops), len(ops), ctypes.addressof(t.slots),
                            len(t.tensors), t.rows, torch.cuda.current_stream(device).cuda_stream)
    return t.tensors[len(inputs):]


def rowlocal_mlp(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The outputs of ``ops`` over ``inputs`` (as :func:`rowlocal_chain`)
    for a table with 1 to :data:`MLP_MAX_HEADS` MLP heads, each writing
    ``prediction [rows]`` and its probabilities ``[rows, classes]``; ops
    before a head are its prologue, ops after the last its epilogue. CPU
    tensors run the plain version; CUDA tensors launch the MLP kernel on the
    current stream (no synchronisation) or raise — also for a table or a
    network past the kernel's limits."""
    if not inputs:
        raise ValueError(f"{ROWLOCAL_MLP.name} needs at least one input column")
    device = inputs[0].device
    if device.type == "cpu":
        return rowlocal_mlp_plain(inputs, ops)
    if device.type != "cuda":
        raise RuntimeError(f"{ROWLOCAL_MLP.name} needs CPU or CUDA tensors, got {device}")
    t = _table(inputs, ops, ROWLOCAL_MLP)
    weights, biases, widths, n_layers = t.nets
    if t.rows:
        with torch.cuda.device(device):
            ROWLOCAL_MLP.launch(
                ctypes.addressof(t.ops), len(ops), ctypes.addressof(t.slots), len(t.tensors),
                ctypes.addressof(weights), ctypes.addressof(biases), ctypes.addressof(widths),
                ctypes.addressof(n_layers), len(n_layers), t.rows,
                torch.cuda.current_stream(device).cuda_stream,
            )
    return t.tensors[len(inputs):]


# ---------------------------------------------------------------------------
# the planner's calling convention
# ---------------------------------------------------------------------------


def _build_sparse(specs: Tuple[Any, ...]):
    head = specs[-1]
    pred_col, raw_col = head.output_names
    idf_spec = specs[0] if len(specs) == 2 else None
    (in_col,) = (idf_spec or head).input_cols
    in_v, in_i, in_z = sparse_names(in_col)
    out_names = sparse_names(head.input_cols[0]) if idf_spec is not None else None

    def mega(models, cols):
        tfidf, _margin, pred, raw = sparse_idf_logistic(
            cols[in_v], cols[in_i],
            models[0]["idf"] if idf_spec is not None else None,
            models[-1]["coefficient"],
            write_tfidf=idf_spec is not None,
        )
        out = {}
        if out_names is not None:  # ids and nnz pass through: the input tensors
            out_v, out_i, out_z = out_names
            out.update({out_v: tfidf, out_i: cols[in_i], out_z: cols[in_z]})
        out[pred_col] = pred
        out[raw_col] = raw
        return out

    return mega


def _scale_stage(specs: Tuple[Any, ...]):
    """``(input column, scaled column or None, with_mean, with_std)`` of a
    dense chain: the scaler's, or the head's input when it runs alone."""
    if len(specs) == 2:
        scale = specs[0]
        (in_col,) = scale.input_cols
        (scaled_col,) = scale.output_names
        return in_col, scaled_col, bool(scale.fusion_params["with_mean"]), bool(
            scale.fusion_params["with_std"])
    (in_col,) = specs[-1].input_cols
    return in_col, None, False, False


def _build_dense(specs: Tuple[Any, ...]):
    pred_col, raw_col = specs[-1].output_names
    in_col, scaled_col, with_mean, with_std = _scale_stage(specs)

    def mega(models, cols):
        scale_model = models[0] if scaled_col is not None else {}
        scaled, pred, raw = scale_logistic(
            cols[in_col],
            scale_model.get("mean"),
            scale_model.get("inv_std"),
            models[-1]["coefficient"],
            with_mean=with_mean,
            with_std=with_std,
            write_scaled=scaled_col is not None,
        )
        out = {} if scaled_col is None else {scaled_col: scaled}
        out[pred_col] = pred
        out[raw_col] = raw
        return out

    return mega


def _build_kmeans(specs: Tuple[Any, ...]):
    head = specs[-1]
    (pred_col,) = head.output_names
    measure = head.fusion_params["distance_measure"]
    in_col, scaled_col, with_mean, with_std = _scale_stage(specs)

    def mega(models, cols):
        scale_model = models[0] if scaled_col is not None else {}
        scaled, pred = scale_kmeans(
            cols[in_col],
            scale_model.get("mean"),
            scale_model.get("inv_std"),
            models[-1]["centroids"],
            measure=measure,
            with_mean=with_mean,
            with_std=with_std,
            write_scaled=scaled_col is not None,
        )
        out = {} if scaled_col is None else {scaled_col: scaled}
        out[pred_col] = pred
        return out

    return mega


def _build_sparse_idf(specs: Tuple[Any, ...]):
    (spec,) = specs
    in_v, in_i, in_z = sparse_names(spec.input_cols[0])
    out_v, out_i, out_z = sparse_names(spec.output_names[0])

    def mega(models, cols):  # ids and nnz pass through: the input tensors
        tfidf = sparse_idf(cols[in_v], cols[in_i], models[0]["idf"])
        return {out_v: tfidf, out_i: cols[in_i], out_z: cols[in_z]}

    return mega


def _build_rowlocal(specs: Tuple[Any, ...]):
    program = _rowlocal_program(specs)
    run = rowlocal_mlp if program.mlp_heads else rowlocal_chain

    def mega(models, cols):
        inputs, ops = program.bind(models, cols)
        slots = inputs + run(inputs, ops)
        return {name: slots[k] for name, k in program.outputs}

    return mega


def build_megakernel_fn(
    specs: Sequence[Any],
) -> Callable[[Sequence[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``mega(models, cols) -> {output name: tensor}`` for an eligible chain,
    with the planner's program calling convention: ``models`` holds each
    spec's device model tensors, ``cols`` the chain's program inputs (a
    sparse column by its three expanded names)."""
    specs = tuple(specs)
    route = _route(specs)
    if route is None:
        raise ValueError(f"no megakernel for chain {[getattr(s, 'fusion_op', None) for s in specs]}")
    if route == "sparse_idf":
        return _build_sparse_idf(specs)
    if route == "table":
        return _build_rowlocal(specs)
    if specs[-1].fusion_op == "sparse_logistic":
        return _build_sparse(specs)
    if specs[-1].fusion_op == "kmeans":
        return _build_kmeans(specs)
    return _build_dense(specs)
