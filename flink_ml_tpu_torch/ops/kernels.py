"""Shared inference math on tensors — twin of ``flink_ml_tpu/ops/kernels.py``.

Every serving path composes these functions: a servable's per-stage
``transform``, its ``KernelSpec.kernel_fn`` (the planner's programs), and the
plain versions of the CUDA megakernels (``servable/megakernels.py``). So the
per-stage, merged and plain paths run the same PyTorch operations, and the
hand-written kernels are held against them. All math is float32.

The sparse functions take the sparse calling convention's padded layout
(``servable/sparse.py``): ``values [n, K] f32`` and ``ids [n, K] i32`` with
padding slots id 0 / value 0. A gather clamps an id outside ``[0, d)`` the
way the JAX package's indexing does: a negative id counts from the end, then
the id is clipped into range.
"""
from __future__ import annotations

import torch

from flink_ml_tpu_torch.ops.distance import DistanceMeasure

__all__ = [
    "dot_fn",
    "gather_clamped",
    "idf_scale_fn",
    "kmeans_assign_fn",
    "logistic_from_dots_fn",
    "mlp_predict_fn",
    "scale_fn",
    "segment_sum",
    "sparse_dot_fn",
    "sparse_idf_scale_fn",
]


def dot_fn(X: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Dense margins ``X @ coef``: [n, d] · [d] → [n]."""
    return X @ coef


def logistic_from_dots_fn(dots: torch.Tensor):
    """prediction = dot ≥ 0, rawPrediction = [1−p, p] with p = sigmoid(dot)."""
    prob = torch.sigmoid(dots)
    pred = (dots >= 0).to(dots.dtype)
    return pred, torch.stack([1.0 - prob, prob], dim=1)


def kmeans_assign_fn(measure_name: str):
    """Closest-centroid assignment ``(X [n, d], centroids [k, d]) -> [n]``
    int64 indices under ``measure_name`` (``ops/distance.py``): the body of
    the per-stage transform, the merged program and the kmeans megakernel's
    plain version."""
    return DistanceMeasure.get_instance(measure_name).find_closest


def mlp_predict_fn(layers, X: torch.Tensor):
    """Float32 MLP forward: ``relu(h @ W + b)`` per hidden layer, then the
    logits, their softmax and the argmax; returns ``(argmax class index as
    float32 [n], probabilities [n, classes])``. ``layers`` is a sequence of
    ``(W [d_in, d_out], b [d_out])`` pairs, any length. The op order is the
    JAX package's (``mlp_classifier._forward`` + the predict head), and
    ``torch.argmax`` returns the first maximal index, NaN counting as the
    maximum, as ``jnp.argmax`` does."""
    h = X
    for W, b in layers[:-1]:
        h = torch.relu(h @ W + b)
    W, b = layers[-1]
    logits = (h @ W + b).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    return torch.argmax(logits, dim=-1).to(torch.float32), probs


def scale_fn(X: torch.Tensor, mean: torch.Tensor, inv_std: torch.Tensor, *,
             with_mean: bool, with_std: bool) -> torch.Tensor:
    """Standardization: subtract ``mean`` if ``with_mean``, multiply by
    ``inv_std`` if ``with_std`` — two correctly rounded float32 operations,
    never contracted, so the result is bit-identical on every device."""
    out = X
    if with_mean:
        out = out - mean[None, :]
    if with_std:
        out = out * inv_std[None, :]
    return out


def idf_scale_fn(X: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """Term-frequency vectors [n, d] scaled elementwise by ``idf`` [d]."""
    return X * idf[None, :]


def gather_clamped(vec: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``vec[ids]`` with the JAX package's out-of-range rule (module
    docstring); the ids of a packed column are always in range."""
    d = vec.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + d, ids).clamp_(0, d - 1)
    return vec[ids]


def segment_sum(terms: torch.Tensor) -> torch.Tensor:
    """Row sums of ``terms [n, K]`` as a strictly sequential left fold over
    the slot axis, starting from +0.0. A padding slot appends an exact
    identity add, so a row's sum is bit-identical at every nnz cap the
    batch was packed at — which ``torch.sum`` (whose order depends on the
    width and the device) does not promise."""
    acc = torch.zeros(terms.shape[0], dtype=terms.dtype, device=terms.device)
    for k in range(terms.shape[1]):
        acc = acc + terms[:, k]
    return acc


def sparse_dot_fn(values: torch.Tensor, ids: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Padded-layout margins: gather, scale, then the sequential
    :func:`segment_sum` — [n, K] → [n]."""
    return segment_sum(values * gather_clamped(coef, ids))


def sparse_idf_scale_fn(values: torch.Tensor, ids: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """Sparse term-frequency entries scaled by their dimension's idf — one
    gather and one multiply per slot; ids and nnz pass through."""
    return values * gather_clamped(idf, ids)
