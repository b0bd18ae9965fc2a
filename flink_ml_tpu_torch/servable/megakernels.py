"""The megakernel tier: a whole hot chain as ONE hand-written CUDA kernel.

Twin of ``flink_ml_tpu/servable/megakernels.py``. There, ``build_megakernel_fn``
traces any chain of kernel specs into one row-tiled Pallas kernel. A CUDA
kernel cannot trace Python bodies, so here each chain the port serves has a
kernel written for it, and :func:`chain_eligible` admits exactly those
chains (:data:`MEGAKERNEL_CHAINS`):

- ``("scale", "logistic")`` — StandardScaler → LogisticRegression, and
  ``("logistic",)`` — LogisticRegression alone: ``csrc/megakernel_scale_logistic.cu``
  through :func:`scale_logistic`;
- ``("sparse_idf", "sparse_logistic")`` — IDF → LogisticRegression on a
  SparseVector column in the sparse calling convention, and
  ``("sparse_logistic",)`` — the sparse head alone:
  ``csrc/megakernel_sparse_idf_logistic.cu`` through :func:`sparse_idf_logistic`;
- ``("scale", "mlp")`` — StandardScaler → MLPClassifier, and ``("mlp",)`` —
  the MLP alone: ``csrc/megakernel_scale_mlp.cu`` through :func:`scale_mlp`,
  for networks within the kernel's limits (:data:`MLP_MAX_LAYERS`,
  :data:`MLP_MAX_WIDTH`, :data:`MLP_MAX_CLASSES`);
- ``("scale", "kmeans")`` — StandardScaler → KMeans, and ``("kmeans",)`` —
  the closest-centroid assignment alone: ``csrc/megakernel_scale_kmeans.cu``
  through :func:`scale_kmeans`, for models within the kernel's limits
  (:data:`KMEANS_MAX_K`, :data:`KMEANS_MAX_DIM`).

Every other chain the JAX package admits (``("scale",)`` alone, the feature6
chain, normalize), and an MLP or a KMeans model past those limits, stays on
the merged program in fast mode until its kernel is written.

Each wrapper chooses by the device of its input: tensors on the CPU take the
plain version — the same chain composed from ``ops/kernels.py`` — and CUDA
tensors launch the kernel or raise. There is no fallback from a failed build
or launch to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.native import CudaKernel
from flink_ml_tpu_torch.ops.kernels import (
    dot_fn,
    kmeans_assign_fn,
    logistic_from_dots_fn,
    mlp_predict_fn,
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
    "MLP_MAX_WIDTH",
    "SCALE_KMEANS",
    "SCALE_LOGISTIC",
    "SCALE_MLP",
    "SPARSE_IDF_LOGISTIC",
    "build_megakernel_fn",
    "chain_eligible",
    "scale_kmeans",
    "scale_kmeans_plain",
    "scale_logistic",
    "scale_logistic_plain",
    "scale_mlp",
    "scale_mlp_plain",
    "sparse_idf_logistic",
    "sparse_idf_logistic_plain",
]

#: Fusion-op chains with a hand-written kernel.
MEGAKERNEL_CHAINS = frozenset({
    ("scale", "logistic"),
    ("logistic",),
    ("sparse_idf", "sparse_logistic"),
    ("sparse_logistic",),
    ("scale", "mlp"),
    ("mlp",),
    ("scale", "kmeans"),
    ("kmeans",),
})

#: The MLP networks ``csrc/megakernel_scale_mlp.cu`` holds (its kMaxLayers,
#: kMaxWidth and kMaxClasses).
MLP_MAX_LAYERS = 8
MLP_MAX_WIDTH = 512
MLP_MAX_CLASSES = 32

#: The KMeans models ``csrc/megakernel_scale_kmeans.cu`` holds (its kMaxK and
#: kMaxDim), and its measure flags.
KMEANS_MAX_K = 1024
KMEANS_MAX_DIM = 1024
KMEANS_MEASURES = {"euclidean": 0, "manhattan": 1, "cosine": 2}

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
    argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


SCALE_MLP = CudaKernel(
    name="megakernel_scale_mlp",
    source="megakernel_scale_mlp.cu",
    symbol="megakernel_scale_mlp",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    replaces="flink_ml_tpu/servable/megakernels.py:180",
)


SCALE_KMEANS = CudaKernel(
    name="megakernel_scale_kmeans",
    source="megakernel_scale_kmeans.cu",
    symbol="megakernel_scale_kmeans",
    argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
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
    """Whether this spec run has a megakernel: its fusion ops form a chain
    of :data:`MEGAKERNEL_CHAINS`; the head reads one column (dense, or
    sparse for the sparse chains) and holds one coefficient vector, or, for
    the MLP, a network the kernel can hold (:func:`_mlp_widths`), or, for
    KMeans, centroids the kernel can hold (:func:`_kmeans_width`); and a
    leading stage feeds the head's input column with vectors of the head's
    input width — mean / inv_std for the scaler, idf for the sparse IDF,
    whose output is the sparse column the head reads."""
    ops = tuple(getattr(s, "fusion_op", None) for s in specs)
    if ops not in MEGAKERNEL_CHAINS:
        return False
    head = specs[-1]
    sparse = ops[-1] == "sparse_logistic"
    if ops[-1] == "mlp":
        widths = _mlp_widths(head)
        d = widths[0] if widths else None
    elif ops[-1] == "kmeans":
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


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
                rows, K, d, int(idf is not None), int(write_tfidf),
                torch.cuda.current_stream(device).cuda_stream,
            )
    return tfidf, margin, pred, raw


# ---------------------------------------------------------------------------
# scale → mlp (dense)
# ---------------------------------------------------------------------------


def scale_mlp_plain(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    labels: torch.Tensor,
    *,
    with_mean: bool,
    with_std: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain in plain PyTorch: ``(scaled, prediction, probabilities)``
    — ``scale_fn``, ``mlp_predict_fn`` and the label gather."""
    scaled = scale_fn(x, mean, inv_std, with_mean=with_mean, with_std=with_std)
    pred_idx, probs = mlp_predict_fn(layers, scaled)
    return scaled, labels[pred_idx.long()], probs


def scale_mlp(
    x: torch.Tensor,
    mean: Optional[torch.Tensor],
    inv_std: Optional[torch.Tensor],
    layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    labels: torch.Tensor,
    *,
    with_mean: bool,
    with_std: bool,
    write_scaled: bool,
) -> Tuple[Optional[torch.Tensor], torch.Tensor, torch.Tensor]:
    """``(scaled or None, prediction [rows], probabilities [rows, classes])``
    for ``x`` [rows, d] through the network ``layers`` (``(W [d_in, d_out],
    b [d_out])`` pairs) and the class values ``labels``. CPU tensors run the
    plain version; CUDA tensors launch the kernel on the current stream (no
    synchronisation) or raise — also for a network past the kernel's limits."""
    if x.device.type == "cpu":
        scaled, pred, probs = scale_mlp_plain(
            x, mean, inv_std, layers, labels, with_mean=with_mean, with_std=with_std
        )
        return (scaled if write_scaled else None), pred, probs
    if x.device.type != "cuda":
        raise RuntimeError(f"{SCALE_MLP.name} needs CPU or CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, d], got shape {tuple(x.shape)}")
    rows = int(x.shape[0])
    widths = [int(x.shape[1])] + [int(W.shape[-1]) for W, _ in layers]
    if not 1 <= len(layers) <= MLP_MAX_LAYERS or not all(1 <= w <= MLP_MAX_WIDTH for w in widths) \
            or widths[-1] > MLP_MAX_CLASSES:
        raise ValueError(
            f"{SCALE_MLP.name} holds 1-{MLP_MAX_LAYERS} layers of widths 1-{MLP_MAX_WIDTH} and "
            f"at most {MLP_MAX_CLASSES} classes; got widths {widths}"
        )
    device = x.device
    _check("x", x, (rows, widths[0]), device)
    for i, (W, b) in enumerate(layers):
        _check(f"W{i}", W, (widths[i], widths[i + 1]), device)
        _check(f"b{i}", b, (widths[i + 1],), device)
    _check("labels", labels, (widths[-1],), device)
    if with_mean:
        _check("mean", mean, (widths[0],), device)
    if with_std:
        _check("inv_std", inv_std, (widths[0],), device)
    scaled = torch.empty((rows, widths[0]), dtype=torch.float32, device=device) if write_scaled else None
    pred = torch.empty((rows,), dtype=torch.float32, device=device)
    probs = torch.empty((rows, widths[-1]), dtype=torch.float32, device=device)
    n = len(layers)
    weights = (ctypes.c_void_p * n)(*[W.data_ptr() for W, _ in layers])
    biases = (ctypes.c_void_p * n)(*[b.data_ptr() for _, b in layers])
    c_widths = (ctypes.c_int * (n + 1))(*widths)
    if not rows:
        return scaled, pred, probs
    with torch.cuda.device(device):
        SCALE_MLP.launch(
            x.data_ptr(),
            mean.data_ptr() if with_mean else None,
            inv_std.data_ptr() if with_std else None,
            ctypes.addressof(weights),
            ctypes.addressof(biases),
            ctypes.addressof(c_widths),
            n,
            labels.data_ptr(),
            scaled.data_ptr() if write_scaled else None,
            pred.data_ptr(),
            probs.data_ptr(),
            rows, int(with_mean), int(with_std), int(write_scaled),
            torch.cuda.current_stream(device).cuda_stream,
        )
    return scaled, pred, probs


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


def _build_mlp(specs: Tuple[Any, ...]):
    pred_col, probs_col = specs[-1].output_names
    n_layers = len(_mlp_widths(specs[-1])) - 1
    in_col, scaled_col, with_mean, with_std = _scale_stage(specs)

    def mega(models, cols):
        scale_model = models[0] if scaled_col is not None else {}
        head = models[-1]
        scaled, pred, probs = scale_mlp(
            cols[in_col],
            scale_model.get("mean"),
            scale_model.get("inv_std"),
            [(head[f"W{i}"], head[f"b{i}"]) for i in range(n_layers)],
            head["labels"],
            with_mean=with_mean,
            with_std=with_std,
            write_scaled=scaled_col is not None,
        )
        out = {} if scaled_col is None else {scaled_col: scaled}
        out[pred_col] = pred
        out[probs_col] = probs
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


def build_megakernel_fn(
    specs: Sequence[Any],
) -> Callable[[Sequence[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``mega(models, cols) -> {output name: tensor}`` for an eligible chain,
    with the planner's program calling convention: ``models`` holds each
    spec's device model tensors, ``cols`` the chain's program inputs (a
    sparse column by its three expanded names)."""
    specs = tuple(specs)
    if not chain_eligible(specs):
        raise ValueError(f"no megakernel for chain {[s.fusion_op for s in specs]}")
    if specs[-1].fusion_op == "sparse_logistic":
        return _build_sparse(specs)
    if specs[-1].fusion_op == "mlp":
        return _build_mlp(specs)
    if specs[-1].fusion_op == "kmeans":
        return _build_kmeans(specs)
    return _build_dense(specs)
