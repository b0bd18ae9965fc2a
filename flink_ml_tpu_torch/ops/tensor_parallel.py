"""Tensor-parallel forms of the serving bodies whose model arrays a plan's
model axis splits.

A plan with ``serving.mesh.model`` (or ``batch.mesh.model``) above 1 splits
the output dimension of every 2-D model array at least ``TP_MIN_WIDTH`` wide
and divisible by the model axis (``servable/sharding.py``, ``put_model``),
where the JAX package's SPMD partitioner splits it. PyTorch has no
partitioner, so each body that reads such an array takes its split form
here, written out by hand. Of the ported kernel specs, two hold 2-D model
arrays:

- the MLP's layer weights ``W{i}`` [d_in, d_out] (``mlp_predict_fn``): each
  model shard computes its output columns, and the columns are concatenated
  (:func:`matmul`);
- KMeans' ``centroids`` [k, d] (``ops/distance.py``): split along ``d``,
  each shard's partial dot products and squared norms are added in the
  fixed order of the model shards (:func:`column_partials`).

Every other model array is 1-D and stays replicated. The split results carry
the tensor-parallel tier's envelope, not bit-equality with the unsplit path:
a shard's product runs at another shape.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from flink_ml_tpu_torch.ops import rowstable

__all__ = ["ColumnShards", "column_partials", "matmul", "ordered_sum"]


class ColumnShards(tuple):
    """A 2-D model array split along its last axis into one piece a model
    shard, in model-shard order; each piece lives on its shard's device.
    ``shape`` is the whole array's."""

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self[0].shape[0]), sum(int(p.shape[1]) for p in self))

    def column_bounds(self) -> List[Tuple[int, int]]:
        """``(lo, hi)`` of each piece's columns in the whole array."""
        bounds, lo = [], 0
        for p in self:
            bounds.append((lo, lo + int(p.shape[1])))
            lo += int(p.shape[1])
        return bounds


def matmul(h: torch.Tensor, w) -> torch.Tensor:
    """``h @ w`` (``ops/rowstable.py``); a split ``w`` computes
    each model shard's output columns on its device and concatenates them
    on ``h``'s."""
    if not isinstance(w, ColumnShards):
        return rowstable.matmul(h, w)
    return torch.cat([rowstable.matmul(h.to(p.device), p).to(h.device) for p in w], dim=1)


def column_partials(x: torch.Tensor, shards: ColumnShards,
                    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> List[torch.Tensor]:
    """``fn(x[:, lo:hi], piece)`` for each model shard's piece of a [k, d]
    array split along ``d``, run on the piece's device and returned on
    ``x``'s, in model-shard order."""
    return [fn(x[:, lo:hi].to(p.device), p).to(x.device)
            for (lo, hi), p in zip(shards.column_bounds(), shards)]


def ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right: the model shards'
    fixed order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc
