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
"""
from __future__ import annotations

import torch

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

    def pairwise(self, points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
        """[n, d] × [k, d] → [n, k] distances."""
        raise NotImplementedError

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The distance of one pair of vectors [d]."""
        return self.pairwise(a[None, :], b[None, :])[0, 0]

    def find_closest(self, points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
        """[n, d] × [k, d] → [n] int64 indices of the closest centroid: the
        first minimum, NaN counting as the minimum."""
        return torch.argmin(self.pairwise(points, centroids), dim=1)


def _sq_norms(v: torch.Tensor) -> torch.Tensor:
    """``Σ v²`` per row."""
    return torch.sum(v * v, dim=1)


class EuclideanDistance(DistanceMeasure):
    NAME = "euclidean"

    def pairwise(self, points, centroids):
        p2 = _sq_norms(points)[:, None]
        c2 = _sq_norms(centroids)[None, :]
        sq = torch.clamp_min(p2 + c2 - 2.0 * points @ centroids.T, 0.0)  # NaN passes
        return torch.sqrt(sq)


class ManhattanDistance(DistanceMeasure):
    NAME = "manhattan"

    def pairwise(self, points, centroids):
        k, d = centroids.shape
        step = max(1, _MANHATTAN_CHUNK_ELEMENTS // max(1, k * d))
        if points.shape[0] <= step:
            return torch.sum(torch.abs(points[:, None, :] - centroids[None, :, :]), dim=-1)
        return torch.cat([
            torch.sum(torch.abs(points[i:i + step, None, :] - centroids[None, :, :]), dim=-1)
            for i in range(0, points.shape[0], step)
        ])


class CosineDistance(DistanceMeasure):
    NAME = "cosine"

    def pairwise(self, points, centroids):
        pn = torch.sqrt(_sq_norms(points))[:, None]
        cn = torch.sqrt(_sq_norms(centroids))[None, :]
        return 1.0 - (points @ centroids.T) / pn / cn
