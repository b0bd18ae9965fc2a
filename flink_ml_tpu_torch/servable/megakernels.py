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
  ``csrc/megakernel_sparse_idf_logistic.cu`` through :func:`sparse_idf_logistic`.

Every other chain the JAX package admits (``("scale",)`` alone, the feature6
chain, scale → mlp, kmeans, normalize) stays on the merged program in fast
mode until its kernel is written.

Each wrapper chooses by the device of its input: tensors on the CPU take the
plain version — the same chain composed from ``ops/kernels.py`` — and CUDA
tensors launch the kernel or raise. There is no fallback from a failed build
or launch to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.native import CudaKernel
from flink_ml_tpu_torch.ops.kernels import (
    dot_fn,
    logistic_from_dots_fn,
    scale_fn,
    sparse_dot_fn,
    sparse_idf_scale_fn,
)
from flink_ml_tpu_torch.servable.sparse import sparse_names

__all__ = [
    "MEGAKERNEL_CHAINS",
    "SCALE_LOGISTIC",
    "SPARSE_IDF_LOGISTIC",
    "build_megakernel_fn",
    "chain_eligible",
    "scale_logistic",
    "scale_logistic_plain",
    "sparse_idf_logistic",
    "sparse_idf_logistic_plain",
]

#: Fusion-op chains with a hand-written kernel.
MEGAKERNEL_CHAINS = frozenset({
    ("scale", "logistic"),
    ("logistic",),
    ("sparse_idf", "sparse_logistic"),
    ("sparse_logistic",),
})

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


def chain_eligible(specs: Sequence[Any]) -> bool:
    """Whether this spec run has a megakernel: its fusion ops form a chain
    of :data:`MEGAKERNEL_CHAINS`, the head reads one column (dense, or
    sparse for the sparse chains) and holds one coefficient vector, and a
    leading stage feeds the head's input column with vectors of the
    coefficient's width — mean / inv_std for the scaler, idf for the sparse
    IDF, whose output is the sparse column the head reads."""
    ops = tuple(getattr(s, "fusion_op", None) for s in specs)
    if ops not in MEGAKERNEL_CHAINS:
        return False
    head = specs[-1]
    sparse = ops[-1] == "sparse_logistic"
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


def _build_dense(specs: Tuple[Any, ...]):
    head = specs[-1]
    pred_col, raw_col = head.output_names
    if len(specs) == 2:
        scale = specs[0]
        (in_col,) = scale.input_cols
        (scaled_col,) = scale.output_names
        with_mean = bool(scale.fusion_params["with_mean"])
        with_std = bool(scale.fusion_params["with_std"])
    else:
        (in_col,) = head.input_cols
        scaled_col, with_mean, with_std = None, False, False

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
    return _build_dense(specs)
