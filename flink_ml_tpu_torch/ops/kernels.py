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

The host-featurized ``"entries"`` kind (HashingTF, CountVectorizer,
FeatureHasher) arrives as raw entries, duplicates allowed:
:func:`sparse_combine_fn` sorts and folds them into the convention's
sorted-unique layout, :func:`sparse_threshold_fn` drops entries under a
per-row bar, and both compact through :func:`sparse_compact_fn`. In the JAX
package these are plain jnp, not Pallas, so they are plain PyTorch here;
every sort is stable and every sum runs in slot order, so CPU and CUDA
give the JAX package's bits.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.ops import rowstable, tensor_parallel
from flink_ml_tpu_torch.ops.distance import DistanceMeasure

__all__ = [
    "binarize_fn",
    "compute_dots",
    "dot_fn",
    "elementwise_product_fn",
    "gather_clamped",
    "idf_scale_fn",
    "impute_fn",
    "kmeans_assign_fn",
    "logistic_from_dots_fn",
    "mlp_predict_fn",
    "normalize_fn",
    "scale_fn",
    "segment_sum",
    "sparse_combine_fn",
    "sparse_compact_fn",
    "sparse_dot_fn",
    "sparse_idf_scale_fn",
    "sparse_threshold_fn",
]

_INT32_MAX = 2**31 - 1


def dot_fn(X: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Dense margins ``X @ coef``: [n, d] · [d] → [n], through
    ``ops/rowstable.py`` (cuBLAS on CUDA outside a sharded plan)."""
    return rowstable.matmul(X, coef)


def compute_dots(df, features_col: str, coefficient, device: torch.device) -> torch.Tensor:
    """Margins ``x·coef`` [n] float32 on ``device`` for a DataFrame's
    features column, dense or SparseVector (JAX ``ops/kernels.py:179``). A
    sparse column stays in its padded-CSR batch (:func:`sparse_dot_fn`), so
    a wide transform never builds an [n, d] array. Shared by the linear
    family's transforms."""
    coef = torch.from_numpy(np.ascontiguousarray(coefficient, np.float32)).to(device)
    if df.is_sparse(features_col):
        batch = df.sparse_batch(features_col)
        if batch.dim != coef.shape[0]:
            raise ValueError(f"features dim {batch.dim} != model dim {coef.shape[0]}")
        values = torch.from_numpy(batch.values).to(device)
        return sparse_dot_fn(values, torch.from_numpy(batch.indices).to(device), coef)
    X = torch.from_numpy(np.ascontiguousarray(df.vectors(features_col), np.float32)).to(device)
    return dot_fn(X, coef)


def logistic_from_dots_fn(dots: torch.Tensor):
    """prediction = dot ≥ 0, rawPrediction = [1−p, p] with p = sigmoid(dot),
    each row's bits independent of the row count (``ops/rowstable.py``: on
    CUDA ``torch.sigmoid`` as it is)."""
    prob = rowstable.sigmoid(dots)
    pred = (dots >= 0).to(dots.dtype)
    return pred, torch.stack([1.0 - prob, prob], dim=1)


def kmeans_assign_fn(measure_name: str):
    """Closest-centroid assignment ``(X [n, d], centroids [k, d]) -> [n]``
    int64 indices under ``measure_name`` (``ops/distance.py``), through
    ``ops/rowstable.py``: the body of the per-stage transform, the merged program
    and the kmeans megakernel's plain version."""
    measure = DistanceMeasure.get_instance(measure_name)
    return lambda X, centroids: measure.find_closest(X, centroids, stable=True)


def mlp_predict_fn(layers, X: torch.Tensor):
    """Float32 MLP forward: ``relu(h @ W + b)`` per hidden layer, then the
    logits, their softmax and the argmax; returns ``(argmax class index as
    float32 [n], probabilities [n, classes])``. ``layers`` is a sequence of
    ``(W [d_in, d_out], b [d_out])`` pairs, any length. The op order is the
    JAX package's (``mlp_classifier._forward`` + the predict head), and
    ``torch.argmax`` returns the first maximal index, NaN counting as the
    maximum, as ``jnp.argmax`` does. The products go through
    ``ops/rowstable.py`` (cuBLAS on CUDA outside a sharded plan); a ``W`` split by a tensor-parallel plan is a
    ``ColumnShards`` (``ops/tensor_parallel.py``)."""
    h = X
    for W, b in layers[:-1]:
        h = torch.relu(tensor_parallel.matmul(h, W) + b)
    W, b = layers[-1]
    logits = (tensor_parallel.matmul(h, W) + b).to(torch.float32)
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


def normalize_fn(X: torch.Tensor, p: float) -> torch.Tensor:
    """Each row of ``X`` [n, d] scaled to unit p-norm, ``norm = (Σ|x|^p)^(1/p)``
    with ``p`` ≥ 1 static; a zero row stays zero and a NaN spreads over its
    row (``Normalizer.java``). The JAX package's op order: the power, the
    row sum (``ops/rowstable.py``), the root, then one divide."""
    norm = rowstable.sum_last(torch.abs(X) ** p)[:, None] ** (1.0 / p)
    return X / torch.where(norm == 0.0, 1.0, norm)


def elementwise_product_fn(X: torch.Tensor, scaling: torch.Tensor) -> torch.Tensor:
    """Hadamard product of each row with ``scaling`` [d] (``ElementwiseProduct.java``)."""
    return X * scaling[None, :]


def binarize_fn(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """``x > threshold`` as 1 / 0 in ``x``'s dtype, the threshold rounded to
    that dtype first (as JAX rounds a Python float); NaN gives 0
    (``Binarizer.java``)."""
    return (x > threshold).to(x.dtype)


def impute_fn(x: torch.Tensor, surrogate: torch.Tensor, missing_is_nan: bool,
              missing_value: float) -> torch.Tensor:
    """Missing entries of ``x`` replaced by ``surrogate`` (``ImputerModel.java``).
    A NaN placeholder tests ``isnan`` (the caller canonicalizes it to
    ``(True, 0.0)``); any other compares ``x == missing_value`` with the
    placeholder rounded to ``x``'s dtype, as the JAX package compares it."""
    miss = torch.isnan(x) if missing_is_nan else (x == missing_value)
    return torch.where(miss, surrogate, x)


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


def _valid_slots(shape_like: torch.Tensor, nnz: torch.Tensor) -> torch.Tensor:
    """[n, K] mask of a row's real (non-padding) slots: slot index < row nnz."""
    slots = torch.arange(shape_like.shape[1], device=shape_like.device)
    return slots[None, :] < nnz[:, None]


def sparse_compact_fn(values: torch.Tensor, ids: torch.Tensor, keep: torch.Tensor):
    """The kept entries of each row moved to its leading slots in their
    order, the tail zeroed: ``(values, ids, keep) -> (values, ids, nnz)``.
    A stable sort on the drop mask moves every kept entry forward without
    reordering kept against kept."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    svals = torch.gather(torch.where(keep, values, 0.0), 1, order)
    sids = torch.gather(torch.where(keep, ids, 0), 1, order)
    return svals, sids, keep.sum(dim=1, dtype=torch.int32)


def sparse_combine_fn(values: torch.Tensor, ids: torch.Tensor, nnz: torch.Tensor):
    """Per-row duplicate-combine of raw entries (JAX ``ops/kernels.py:528``):
    each row's entries sorted by id (stable, padding keyed ``INT32_MAX``
    so it sorts last), the values of each equal-id run summed strictly in
    slot order, one entry kept per id, compacted. The fold runs over the
    slot columns, one float32 ``v + where(same, acc, 0)`` a step as in the
    JAX ``lax.scan``: FeatureHasher's float values make the order matter,
    which a cumulative sum or an atomic scatter would not keep."""
    valid = _valid_slots(ids, nnz)
    skey = torch.where(valid, ids, _INT32_MAX)
    order = torch.argsort(skey, dim=1, stable=True)
    sids = torch.gather(skey, 1, order)
    svals = torch.gather(torch.where(valid, values, 0.0), 1, order)
    svalid = torch.gather(valid, 1, order)
    # same[:, j]: slot j continues slot j-1's id run (padding never matches
    # a real id: its key is INT32_MAX)
    prev = torch.cat([torch.full_like(sids[:, :1], -1), sids[:, :-1]], dim=1)
    same = sids == prev
    run = torch.empty_like(svals)
    acc = torch.zeros_like(svals[:, 0])
    for j in range(svals.shape[1]):
        acc = svals[:, j] + torch.where(same[:, j], acc, 0.0)
        run[:, j] = acc
    nxt = torch.cat([same[:, 1:], torch.zeros_like(same[:, :1])], dim=1)
    return sparse_compact_fn(run, sids, svalid & ~nxt)  # each run's last slot holds its sum


def sparse_threshold_fn(values: torch.Tensor, ids: torch.Tensor, nnz: torch.Tensor,
                        threshold: torch.Tensor):
    """Entries below the per-row ``threshold [n]`` dropped
    (CountVectorizer's minTF), the survivors compacted."""
    keep = _valid_slots(ids, nnz) & (values >= threshold[:, None])
    return sparse_compact_fn(values, ids, keep)
