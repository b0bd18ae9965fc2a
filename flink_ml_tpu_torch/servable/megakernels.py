"""The megakernel tier: a whole hot chain as ONE hand-written CUDA kernel.

Twin of ``flink_ml_tpu/servable/megakernels.py``. There, ``build_megakernel_fn``
traces any chain of kernel specs into one row-tiled Pallas kernel. A CUDA
kernel cannot trace Python bodies, so here a chain runs either on a kernel
written for it, or on the row-local kernel, which composes its chain at
launch from a small op table. :func:`chain_eligible` admits:

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

- every other chain of the table ops (:data:`TABLE_OPS`: the row-local ops
  scale, normalize, elementwise_product, idf, binarize and impute, and the
  dense ``logistic`` and ``kmeans`` heads, anywhere in the chain):
  ``csrc/megakernel_rowlocal.cu`` through :func:`rowlocal_chain`, which
  composes the chain from an op table (``csrc/rowlocal_ops.cuh``) — for
  example ``("normalize", "kmeans")`` or ``("scale", "normalize", "kmeans")``;
- every chain closed by an ``mlp`` head whose earlier ops (none or more)
  are table ops: ``csrc/megakernel_scale_mlp.cu`` through
  :func:`rowlocal_mlp`, the MLP kernel with the table as its prologue — for
  example ``("mlp",)``, ``("scale", "mlp")`` or ``("normalize", "mlp")`` —
  for networks within the kernel's limits (:data:`MLP_MAX_LAYERS`,
  :data:`MLP_MAX_WIDTH`, :data:`MLP_MAX_CLASSES`).

The tables and widths must be within the kernels' limits
(:data:`ROWLOCAL_MAX_OPS`, :data:`ROWLOCAL_MAX_SLOTS`, :data:`ROWLOCAL_MAX_DIM`,
the centroids a table's kmeans ops may hold in all,
:data:`ROWLOCAL_MAX_NORM_FLOATS` and :data:`MLP_MAX_NORM_FLOATS`; the widths
of the batch's input columns are checked per key by :func:`inputs_fit`).

The chains the JAX package admits and the port does not (they stay on the
merged program in fast mode) are :data:`REFUSED` — an MLP head followed by
further ops, a sparse op in the same run as a dense one, sparse runs other
than the three above, an op reading a kmeans index — and any model past a
kernel's limits.

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
    "MLP_MAX_LAYERS",
    "MLP_MAX_NORM_FLOATS",
    "MLP_MAX_WIDTH",
    "REFUSED",
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

#: The MLP networks ``csrc/megakernel_scale_mlp.cu`` holds (its kMaxLayers,
#: kMaxWidth and kMaxClasses), and the centroids its prologue's kmeans ops
#: may hold in all (kMaxNormFloats: their norms share the block's shared
#: memory with the activations).
MLP_MAX_LAYERS = 8
MLP_MAX_WIDTH = 512
MLP_MAX_CLASSES = 32
MLP_MAX_NORM_FLOATS = 16 * 1024

#: The KMeans models ``csrc/megakernel_scale_kmeans.cu`` holds (its kMaxK and
#: kMaxDim), and its measure flags.
KMEANS_MAX_K = 1024
KMEANS_MAX_DIM = 1024
KMEANS_MEASURES = {"euclidean": 0, "manhattan": 1, "cosine": 2}

#: The row-local ops of ``csrc/rowlocal_ops.cuh``'s table; with the dense
#: ``logistic`` and ``kmeans`` heads they are :data:`TABLE_OPS`, the ops a
#: table may hold in any order. The table's limits: a lane's slots of a row
#: (kMaxDim), the op table (kMaxOps) and the slot table (kMaxSlots) in the
#: kernel's parameters, and the centroids the table's kmeans ops may hold in
#: all (``csrc/megakernel_rowlocal.cu`` kMaxNormFloats, their norms in the
#: block's shared memory).
ROWLOCAL_OPS = frozenset({"scale", "normalize", "elementwise_product", "idf", "binarize", "impute"})
TABLE_OPS = ROWLOCAL_OPS | {"logistic", "kmeans"}
ROWLOCAL_MAX_DIM = 1024
ROWLOCAL_MAX_OPS = 32
ROWLOCAL_MAX_SLOTS = 64
ROWLOCAL_MAX_NORM_FLOATS = 48 * 1024

#: What the JAX package lowers as one megakernel and the port refuses: each
#: entry names a class of chains and a chain of it (fusion ops). Past these,
#: the port refuses only models past its kernels' limits.
REFUSED = {
    "mlp_not_last": ("mlp", "scale"),  # an MLP head followed by further ops
    "sparse_with_dense": ("sparse_idf", "sparse_logistic", "scale"),  # one run, both conventions
    "other_sparse_run": ("sparse_idf", "sparse_idf"),  # a sparse run past the three kernels have
    "reads_kmeans_index": ("kmeans", "binarize"),  # an op reading a kmeans index column
}

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
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
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
    chain of :data:`TABLE_OPS`, or an MLP head after none or more of them,
    on the row-local kernel or the MLP kernel's table prologue when every
    spec is of its form (:func:`_rowlocal_program`)."""
    return _route(specs) is not None


def _route(specs: Sequence[Any]) -> Optional[str]:
    """Which kernel runs ``specs``: ``"dedicated"``, ``"sparse_idf"``,
    ``"table"`` (the row-local kernel or the MLP prologue), or None."""
    specs = tuple(specs)
    ops = tuple(getattr(s, "fusion_op", None) for s in specs)
    if ops in MEGAKERNEL_CHAINS and _dedicated_eligible(specs, ops):
        return "dedicated"
    if ops == ("sparse_idf",):
        return "sparse_idf" if _sparse_idf_width(specs[0]) is not None else None
    return "table" if _rowlocal_program(specs) is not None else None


def inputs_fit(specs: Sequence[Any], inputs: Mapping[str, torch.Tensor]) -> bool:
    """Whether a batch's program ``inputs`` fit the kernel of an eligible
    chain: the table kernels take [rows] or [rows, width] columns of width
    ≤ :data:`ROWLOCAL_MAX_DIM`, which only the batch shows (a normalize or
    binarize spec carries no width); the dedicated kernels' widths are fixed
    by their model arrays, checked by :func:`chain_eligible`."""
    if _route(specs) != "table":
        return True
    return all(t.dim() == 1 or (t.dim() == 2 and 1 <= t.shape[1] <= ROWLOCAL_MAX_DIM)
               for t in inputs.values())


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


class _OpTemplate(NamedTuple):
    """One op of a table chain before its model tensors are known: the op,
    its input slot, the spec it comes from, the names of that spec's model
    arrays it reads (``a``, ``b``) and its static parameters."""

    op: str
    src: int
    spec: int
    a: Optional[str]
    b: Optional[str]
    params: Mapping[str, Any]


class _MlpHead(NamedTuple):
    """The MLP head closing a table chain: the slot it reads and its layers."""

    src: int
    n_layers: int


class _RowLocalProgram(NamedTuple):
    inputs: Tuple[str, ...]  # the chain's program inputs: slots 0..m-1
    ops: Tuple[_OpTemplate, ...]
    outputs: Tuple[str, ...]  # the column of each output slot, m on, in order; then the MLP's
    mlp: Optional[_MlpHead]


def _is_rowlocal_vector(spec: Any, key: str) -> bool:
    a = np.asarray(spec.model_arrays[key])
    return a.ndim == 1 and 1 <= a.shape[0] <= ROWLOCAL_MAX_DIM


def _rowlocal_bindings(spec: Any) -> Optional[List[Tuple[str, Optional[str], Optional[str], Optional[str], Dict[str, Any], Optional[int]]]]:
    """``(input column, output column, a, b, params, width)`` per table entry
    of a :data:`TABLE_OPS` spec of its op's form (one binding per column for
    binarize and impute; the output None for a head, whose outputs are the
    spec's), ``width`` the input width the entry needs (None: any), or None
    when the spec is not of that form."""
    op, ins, outs = spec.fusion_op, spec.input_cols, spec.output_names
    arrays, params = set(spec.model_arrays), spec.fusion_params
    if any(spec.input_kind(c) not in ("vector", "dense", "scalar") for c in ins):
        return None
    if op == "logistic":
        d = _head_width(spec, "vector")
        if d is None or not 1 <= d <= ROWLOCAL_MAX_DIM:
            return None
        return [(ins[0], None, "coefficient", None, {}, d)]
    if op == "kmeans":
        d = _kmeans_width(spec)
        if d is None:
            return None
        return [(ins[0], None, "centroids", None, {"measure": params["distance_measure"]}, d)]
    if op in ("binarize", "impute"):
        if not ins or len(ins) != len(outs):
            return None
        if op == "binarize":
            t = params.get("thresholds")
            if arrays or set(params) != {"thresholds"} or t is None or len(t) != len(ins):
                return None
            return [(i, o, None, None, {"threshold": float(th)}, None)
                    for i, o, th in zip(ins, outs, t)]
        if arrays != {"surrogates"} or set(params) != {"missing_is_nan", "missing_value"}:
            return None
        if np.asarray(spec.model_arrays["surrogates"]).shape != (len(ins),):
            return None
        return [(i, o, "surrogates", None, {"missing_is_nan": bool(params["missing_is_nan"]),
                                            "missing_value": float(params["missing_value"]),
                                            "column": k}, None)
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
        return [(i, o, "mean", "inv_std", {"with_mean": bool(params["with_mean"]),
                                           "with_std": bool(params["with_std"])}, d)]
    if op == "normalize":
        if arrays or set(params) != {"p"} or not float(params["p"]) >= 1.0:
            return None
        return [(i, o, None, None, {"p": float(params["p"])}, None)]
    if op in ("elementwise_product", "idf"):
        key = "scaling" if op == "elementwise_product" else "idf"
        if arrays != {key} or params or not _is_rowlocal_vector(spec, key):
            return None
        return [(i, o, key, None, {}, _vector_width(spec.model_arrays[key]))]
    return None


def _rowlocal_program(specs: Sequence[Any]) -> Optional[_RowLocalProgram]:
    """The table for ``specs``, or None when the chain is not of its form:
    every spec a :data:`TABLE_OPS` op over dense or scalar columns, an
    optional last spec an MLP head the kernel can hold (:func:`_mlp_widths`;
    only with it may the table be empty), no op reading a kmeans index, the
    widths the model arrays fix agreeing, and tables within the kernel's
    limits.

    Slots: the chain's program inputs first, then each op's outputs in
    order. A spec's ops read the columns as they stood before the spec (as
    its ``kernel_fn`` does), and a column written twice names its last
    slot, as the chain's ``cols.update`` leaves it."""
    specs = tuple(specs)
    if not specs:
        return None
    mlp_widths = _mlp_widths(specs[-1]) if getattr(specs[-1], "fusion_op", None) == "mlp" else None
    body = specs[:-1] if mlp_widths is not None else specs
    if not body and mlp_widths is None:
        return None
    bindings = []
    for spec in body:
        if getattr(spec, "fusion_op", None) not in TABLE_OPS:
            return None
        b = _rowlocal_bindings(spec)
        if b is None:
            return None
        bindings.append(b)
    produced: set = set()
    inputs: List[str] = []
    for spec, b in zip(body, bindings):
        for i, *_ in b:
            if i not in produced and i not in inputs:
                inputs.append(i)
        produced.update(spec.output_names)
    if mlp_widths is not None:
        (head_in,) = specs[-1].input_cols
        if head_in not in produced and head_in not in inputs:
            inputs.append(head_in)
    slot = {name: k for k, name in enumerate(inputs)}
    width: Dict[str, int] = {}  # a column's width where a model array fixes it
    index_cols: set = set()  # columns holding kmeans indices
    ops: List[_OpTemplate] = []
    outputs: List[str] = []

    def reads(col: str, need: Optional[int]) -> bool:
        if col in index_cols:
            return False
        if need is not None:
            if width.setdefault(col, need) != need:
                return False
        return True

    for si, (spec, b) in enumerate(zip(body, bindings)):
        srcs = [slot[i] for i, *_ in b]  # read before this spec writes
        if not all(reads(i, need) for i, _o, _a, _b, _p, need in b):
            return None
        in_width = [width.get(i) for i, *_ in b]
        written = []
        for src, w_in, (i, o, a, bb, params, need) in zip(srcs, in_width, b):
            ops.append(_OpTemplate(spec.fusion_op, src, si, a, bb, params))
            names = spec.output_names if o is None else (o,)
            for name in names:
                written.append((name, len(inputs) + len(outputs)))
                outputs.append(name)
                width.pop(name, None)
                index_cols.discard(name)
            if o is not None and w_in is not None:  # an elementwise op keeps its input's width
                width[o] = w_in
            if spec.fusion_op == "kmeans":  # its prediction holds indices
                index_cols.update(names)
        slot.update(written)
    n_slots = len(inputs) + len(outputs)
    centroids = sum(int(np.asarray(spec.model_arrays["centroids"]).shape[0])
                    for spec in body if spec.fusion_op == "kmeans")
    norm_budget = ROWLOCAL_MAX_NORM_FLOATS if mlp_widths is None else MLP_MAX_NORM_FLOATS
    if len(ops) > ROWLOCAL_MAX_OPS or n_slots > ROWLOCAL_MAX_SLOTS or centroids > norm_budget:
        return None
    mlp = None
    if mlp_widths is not None:
        (head_in,) = specs[-1].input_cols
        if not reads(head_in, mlp_widths[0]):
            return None
        mlp = _MlpHead(slot[head_in], len(mlp_widths) - 1)
        outputs.extend(specs[-1].output_names)
    return _RowLocalProgram(tuple(inputs), tuple(ops), tuple(outputs), mlp)


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
    the kernel on the current stream (no synchronisation) or raise."""
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
# row-local chains (dense), composed from an op table
# ---------------------------------------------------------------------------


class RowLocalOp(NamedTuple):
    """One op of a table chain: ``op`` (a :data:`TABLE_OPS` op) reads slot
    ``src``; the model tensors ``a`` (scale's mean, the product's scaling,
    idf, impute's surrogates, the logistic head's coefficient, the kmeans
    head's centroids [k, width]) and ``b`` (scale's inv_std); ``params`` the
    static arguments (``with_mean``/``with_std``; ``p``; ``threshold``;
    ``missing_is_nan``/``missing_value`` and the surrogate's ``column``;
    the kmeans ``measure``). Slots: the chain's inputs, then each op's
    outputs in order — one (int32 indices for kmeans), or ``prediction``
    and ``rawPrediction`` for the logistic head."""

    op: str
    src: int
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    params: Mapping[str, Any] = {}


_ROWLOCAL_CODES = {"scale": 0, "normalize": 1, "elementwise_product": 2, "idf": 3,
                   "binarize": 4, "impute": 5, "logistic": 6, "kmeans": 7}


class _Op(ctypes.Structure):  # csrc/rowlocal_ops.cuh Op
    _fields_ = [("op", ctypes.c_int), ("src", ctypes.c_int), ("dst", ctypes.c_int),
                ("dst2", ctypes.c_int), ("flags", ctypes.c_int), ("k", ctypes.c_int),
                ("s0", ctypes.c_float), ("s1", ctypes.c_float), ("a", ctypes.c_void_p),
                ("b", ctypes.c_void_p)]


class _Slot(ctypes.Structure):  # csrc/rowlocal_ops.cuh Slot
    _fields_ = [("ptr", ctypes.c_void_p), ("width", ctypes.c_int), ("pad", ctypes.c_int)]


def rowlocal_chain_plain(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The chain in plain PyTorch, op by op through ``ops/kernels.py``:
    the output tensors in slot order."""
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
        else:
            raise ValueError(f"{op.op!r} is no table op")
    return slots[len(inputs):]


def _table(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp], kernel: CudaKernel):
    """The ctypes op and slot tables of a chain on CUDA tensors, with the
    output tensors allocated: ``(ops table, slot table, slots, rows)``.
    Raises for a table or a width past the kernel's limits (the MLP
    kernel's table may be empty, the row-local kernel's may not)."""
    device = inputs[0].device
    rows = int(inputs[0].shape[0]) if inputs[0].dim() else -1
    n_slots = len(inputs) + sum(2 if op.op == "logistic" else 1 for op in ops)
    min_ops = 0 if kernel is ROWLOCAL_MLP else 1
    if not min_ops <= len(ops) <= ROWLOCAL_MAX_OPS or n_slots > ROWLOCAL_MAX_SLOTS:
        raise ValueError(f"{kernel.name} holds {min_ops}-{ROWLOCAL_MAX_OPS} ops over at most "
                         f"{ROWLOCAL_MAX_SLOTS} slots; got {len(ops)} ops, {n_slots} slots")
    slots: List[torch.Tensor] = []
    for k, t in enumerate(inputs):
        if t.dim() not in (1, 2) or not 1 <= (t.shape[1] if t.dim() == 2 else 1) <= ROWLOCAL_MAX_DIM:
            raise ValueError(f"{kernel.name} takes [rows] or [rows, 1-{ROWLOCAL_MAX_DIM}] "
                             f"columns; input {k} has shape {tuple(t.shape)}")
        _check(f"input {k}", t, (rows,) + tuple(t.shape[1:]), device)
        slots.append(t)
    table = (_Op * len(ops))()
    for entry, op in zip(table, ops):
        if op.op not in _ROWLOCAL_CODES or not 0 <= op.src < len(slots):
            raise ValueError(f"{kernel.name}: op {op.op!r} reads slot {op.src} of {len(slots)}")
        x, p = slots[op.src], op.params
        if x.dtype != torch.float32:
            raise ValueError(f"{kernel.name}: op {op.op!r} reads slot {op.src} of {x.dtype}")
        width = int(x.shape[1]) if x.dim() == 2 else 1
        needs_a = op.op in ("elementwise_product", "idf", "logistic", "impute", "kmeans") or (
            op.op == "scale" and p["with_mean"])
        if (needs_a and op.a is None) or (op.op == "scale" and p["with_std"] and op.b is None):
            raise ValueError(f"{kernel.name}: op {op.op!r} is missing its model tensor")
        entry.op, entry.src = _ROWLOCAL_CODES[op.op], op.src
        if op.op in ("scale", "elementwise_product", "idf", "logistic", "kmeans"):
            if x.dim() != 2:
                raise ValueError(f"{op.op} reads [rows, d] columns; slot {op.src} has shape {tuple(x.shape)}")
            if op.op in ("elementwise_product", "idf", "logistic") or (op.op == "scale" and p["with_mean"]):
                _check(f"{op.op} model vector", op.a, (width,), device)
                entry.a = op.a.data_ptr()
        if op.op == "scale":
            entry.flags = int(bool(p["with_mean"])) | 2 * int(bool(p["with_std"]))
            if p["with_std"]:
                _check("scale inv_std", op.b, (width,), device)
                entry.b = op.b.data_ptr()
        elif op.op == "normalize":
            if x.dim() != 2 or not float(p["p"]) >= 1.0:
                raise ValueError(f"normalize reads [rows, d] columns with p >= 1; got slot shape "
                                 f"{tuple(x.shape)}, p {p['p']}")
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
        if op.op == "logistic":
            out = [torch.empty((rows,), dtype=torch.float32, device=device),
                   torch.empty((rows, 2), dtype=torch.float32, device=device)]
            entry.dst, entry.dst2 = len(slots), len(slots) + 1
        elif op.op == "kmeans":
            out = [torch.empty((rows,), dtype=torch.int32, device=device)]
            entry.dst = entry.dst2 = len(slots)
        else:
            out = [torch.empty(tuple(x.shape), dtype=torch.float32, device=device)]
            entry.dst = entry.dst2 = len(slots)
        slots.extend(out)
    slot_table = (_Slot * len(slots))()
    for entry, t in zip(slot_table, slots):
        entry.ptr = t.data_ptr()
        entry.width = int(t.shape[1]) if t.dim() == 2 else 1
    return table, slot_table, slots, rows


def rowlocal_chain(inputs: Sequence[torch.Tensor], ops: Sequence[RowLocalOp]) -> List[torch.Tensor]:
    """The outputs of ``ops`` over ``inputs`` ([rows] or [rows, width]
    float32 columns), in slot order (:class:`RowLocalOp`): each elementwise
    op's output of its input's shape, the logistic head's ``prediction
    [rows]`` and ``rawPrediction [rows, 2]``, the kmeans head's int32 index
    [rows]. CPU tensors run the plain version; CUDA tensors launch the kernel
    on the current stream (no synchronisation) or raise — also for a table
    or a width past the kernel's limits."""
    if not inputs:
        raise ValueError(f"{ROWLOCAL.name} needs at least one input column")
    device = inputs[0].device
    if device.type == "cpu":
        return rowlocal_chain_plain(inputs, ops)
    if device.type != "cuda":
        raise RuntimeError(f"{ROWLOCAL.name} needs CPU or CUDA tensors, got {device}")
    table, slot_table, slots, rows = _table(inputs, ops, ROWLOCAL)
    if rows:
        with torch.cuda.device(device):
            ROWLOCAL.launch(ctypes.addressof(table), len(ops), ctypes.addressof(slot_table),
                            len(slots), rows, torch.cuda.current_stream(device).cuda_stream)
    return slots[len(inputs):]


def rowlocal_mlp_plain(
    inputs: Sequence[torch.Tensor],
    ops: Sequence[RowLocalOp],
    head_src: int,
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    labels: torch.Tensor,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch: ``(the table's outputs, prediction,
    probabilities)`` — :func:`rowlocal_chain_plain`, then ``mlp_predict_fn``
    on slot ``head_src`` and the label gather."""
    outs = rowlocal_chain_plain(inputs, ops)
    pred_idx, probs = mlp_predict_fn(layers, (list(inputs) + outs)[head_src])
    return outs, labels[pred_idx.long()], probs


def rowlocal_mlp(
    inputs: Sequence[torch.Tensor],
    ops: Sequence[RowLocalOp],
    head_src: int,
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    labels: torch.Tensor,
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """The table ``ops`` (none or more) over ``inputs`` (as
    :func:`rowlocal_chain`), then the MLP ``layers`` (``(W [d_in, d_out],
    b [d_out])`` pairs) on slot ``head_src``: ``(the table's outputs in slot order, prediction [rows],
    probabilities [rows, classes])``. CPU tensors run the plain version;
    CUDA tensors launch the MLP kernel with the table as its prologue on the
    current stream (no synchronisation) or raise — also for a table or a
    network past the kernel's limits."""
    if not inputs:
        raise ValueError(f"{ROWLOCAL_MLP.name} needs at least one input column")
    device = inputs[0].device
    if device.type == "cpu":
        return rowlocal_mlp_plain(inputs, ops, head_src, layers, labels)
    if device.type != "cuda":
        raise RuntimeError(f"{ROWLOCAL_MLP.name} needs CPU or CUDA tensors, got {device}")
    table, slot_table, slots, rows = _table(inputs, ops, ROWLOCAL_MLP)
    if not 0 <= head_src < len(slots) or slots[head_src].dim() != 2:
        raise ValueError(f"{ROWLOCAL_MLP.name}: the head reads slot {head_src} of {len(slots)}, "
                         f"which must be [rows, d]")
    widths = [int(slots[head_src].shape[1])] + [int(W.shape[-1]) for W, _ in layers]
    if not 1 <= len(layers) <= MLP_MAX_LAYERS or not all(1 <= w <= MLP_MAX_WIDTH for w in widths) \
            or widths[-1] > MLP_MAX_CLASSES:
        raise ValueError(
            f"{ROWLOCAL_MLP.name} holds 1-{MLP_MAX_LAYERS} layers of widths 1-{MLP_MAX_WIDTH} and "
            f"at most {MLP_MAX_CLASSES} classes; got widths {widths}"
        )
    for i, (W, b) in enumerate(layers):
        _check(f"W{i}", W, (widths[i], widths[i + 1]), device)
        _check(f"b{i}", b, (widths[i + 1],), device)
    _check("labels", labels, (widths[-1],), device)
    pred = torch.empty((rows,), dtype=torch.float32, device=device)
    probs = torch.empty((rows, widths[-1]), dtype=torch.float32, device=device)
    n = len(layers)
    weights = (ctypes.c_void_p * n)(*[W.data_ptr() for W, _ in layers])
    biases = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    c_widths = (ctypes.c_int * (n + 1))(*widths)
    if rows:
        with torch.cuda.device(device):
            ROWLOCAL_MLP.launch(
                ctypes.addressof(table), len(ops), ctypes.addressof(slot_table), len(slots),
                head_src, ctypes.addressof(weights), ctypes.addressof(biases),
                ctypes.addressof(c_widths), n, labels.data_ptr(), pred.data_ptr(),
                probs.data_ptr(), rows, torch.cuda.current_stream(device).cuda_stream,
            )
    return slots[len(inputs):], pred, probs


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
    mlp = program.mlp

    def mega(models, cols):
        ops = [RowLocalOp(t.op, t.src, models[t.spec].get(t.a), models[t.spec].get(t.b), t.params)
               for t in program.ops]
        inputs = [cols[name] for name in program.inputs]
        if mlp is None:
            outs = rowlocal_chain(inputs, ops)
        else:
            head = models[-1]
            layers = [(head[f"W{i}"], head[f"b{i}"]) for i in range(mlp.n_layers)]
            outs, pred, probs = rowlocal_mlp(inputs, ops, mlp.src, layers, head["labels"])
            outs = list(outs) + [pred, probs]
        return dict(zip(program.outputs, outs))

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
