"""Distance measures, batched — twin of ``flink_ml_tpu/ops/distance.py``.

The unit of work is ``pairwise(points [n, d], centroids [k, d]) → [n, k]``;
``find_closest`` is the argmin over it. Each measure runs the JAX package's
operations in the JAX package's order, so the two packages round alike and
differ only where a sum is taken in another order:

- euclidean: ``sqrt(max(|x|² + |c|² − 2·x·cᵀ, 0))`` — the clamp guards the
  cancellation of the expanded form, and the square root is taken before
  the argmin;
- manhattan: ``Σ|x − c|``, over bounded row chunks so ``[rows, k, d]`` is
  never materialised for the whole batch;
- cosine: ``1 − (x·cᵀ) / |x| / |c|``, two divides in that order, each norm
  ``sqrt(Σ v²)``. A zero row (or centroid) gives 0/0 = NaN.

``find_closest`` takes the first minimum, and a NaN counts as the minimum:
``torch.argmin`` returns the first NaN, as ``jnp.argmin`` does.

With ``stable=True`` (the serving bodies, ``ops/kernels.py``
``kmeans_assign_fn``) the product ``x·cᵀ`` and every row sum go through
``ops/rowstable.py``: on the CPU, and on CUDA inside a sharded plan, a
row's distances then do not depend on how many rows share the call, which
the sharded plans' bit-equality rests on; training keeps cuBLAS / MKL. Centroids split along ``d`` by a tensor-parallel plan
(``ops/tensor_parallel.py``) arrive as ``ColumnShards``: every sum over ``d``
then adds the model shards' partial sums in their fixed order.
"""
from __future__ import annotations

import torch

from flink_ml_tpu_torch.ops import rowstable
from flink_ml_tpu_torch.ops.tensor_parallel import ColumnShards, column_partials, ordered_sum

__all__ = ["CosineDistance", "DistanceMeasure", "EuclideanDistance", "ManhattanDistance"]

#: Elements of one manhattan chunk's ``[rows, k, d]`` difference tensor
#: (16 MB of float32).
_MANHATTAN_CHUNK_ELEMENTS = 1 << 22


class DistanceMeasure:
    """A metric; subclasses define the batched ``pairwise``."""

    NAME = ""

    _REGISTRY = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.NAME:
            DistanceMeasure._REGISTRY[cls.NAME] = cls

    @staticmethod
    def get_instance(name: str) -> "DistanceMeasure":
        """The measure called ``name``; the JAX package's error otherwise."""
        try:
            return DistanceMeasure._REGISTRY[name]()
        except KeyError:
            raise ValueError(
                f"distanceMeasure {name} is not recognized. Supported options: "
                f"'euclidean, manhattan, cosine'."
            )

    def pairwise(self, points: torch.Tensor, centroids: torch.Tensor, stable: bool = False) -> torch.Tensor:
        """[n, d] × [k, d] → [n, k] distances; ``stable`` takes every product
        and sum in its row-stable form (module docstring)."""
        raise NotImplementedError

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The distance of one pair of vectors [d]."""
        return self.pairwise(a[None, :], b[None, :])[0, 0]

    def find_closest(self, points: torch.Tensor, centroids: torch.Tensor, stable: bool = False) -> torch.Tensor:
        """[n, d] × [k, d] → [n] int64 indices of the closest centroid: the
        first minimum, NaN counting as the minimum."""
        return torch.argmin(self.pairwise(points, centroids, stable), dim=1)


def _sq_norms(v, stable: bool) -> torch.Tensor:
    """``Σ v²`` per row."""
    if isinstance(v, ColumnShards):
        return ordered_sum([_sq_norms(p, stable).to(v[0].device) for p in v])
    return rowstable.sum_last(v * v) if stable else torch.sum(v * v, dim=1)


def _dots(points: torch.Tensor, centroids, stable: bool) -> torch.Tensor:
    """``points @ centroids.T`` [n, k]."""
    if isinstance(centroids, ColumnShards):
        return ordered_sum(column_partials(points, centroids, lambda x, c: _dots(x, c, stable)))
    return rowstable.matmul(points, centroids.T) if stable else points @ centroids.T


class EuclideanDistance(DistanceMeasure):
    NAME = "euclidean"

    def pairwise(self, points, centroids, stable=False):
        p2 = _sq_norms(points, stable)[:, None]
        c2 = _sq_norms(centroids, stable).to(points.device)[None, :]
        sq = torch.clamp_min(p2 + c2 - 2.0 * _dots(points, centroids, stable), 0.0)  # NaN passes
        return torch.sqrt(sq)


class ManhattanDistance(DistanceMeasure):
    NAME = "manhattan"

    def pairwise(self, points, centroids, stable=False):
        if isinstance(centroids, ColumnShards):
            return ordered_sum(column_partials(points, centroids, lambda x, c: self.pairwise(x, c, stable)))
        k, d = centroids.shape
        step = max(1, _MANHATTAN_CHUNK_ELEMENTS // max(1, k * d))
        total = rowstable.sum_last if stable else (lambda t: torch.sum(t, dim=-1))
        return torch.cat([
            total(torch.abs(points[i:i + step, None, :] - centroids[None, :, :]))
            for i in range(0, max(1, points.shape[0]), step)
        ])


class CosineDistance(DistanceMeasure):
    NAME = "cosine"

    def pairwise(self, points, centroids, stable=False):
        pn = torch.sqrt(_sq_norms(points, stable))[:, None]
        cn = torch.sqrt(_sq_norms(centroids, stable)).to(points.device)[None, :]
        return 1.0 - _dots(points, centroids, stable) / pn / cn
