"""K-means clustering — twin of ``flink_ml_tpu/models/clustering/kmeans.py``
on one device.

fit: ``k`` rows drawn as the initial centroids by
``np.random.default_rng(seed).choice(n, k, replace=False)`` on the host, as
the JAX package draws them, so both packages start from the same rows. The
points stay resident on the device (``DeviceDataCache``) and every epoch is
``_epoch_update``: the closest centroid of every point (``ops/distance.py``),
the partial sums as the product ``one_hot(assign)ᵀ @ X`` and the counts as
the one-hot's column sums, then sum / count — a centroid with no point
keeps its position. The product is a deterministic float32 GEMM (TF32 off,
``device.resolve_device``); ``index_add_`` is not used, because its CUDA
atomics change the bits from run to run. The JAX package runs all epochs
as one ``lax.scan`` program; here the epochs are a Python loop of tensor
operations that never reads the device, so the host only queues work and
the one readback is the final model's.

``KMeansModel`` predicts the index of the closest centroid, as DOUBLE; its
model data is ``centroids [k, d]`` and ``weights [k]`` (the last epoch's
cluster sizes).

Not ported yet, each raising an error that names ROADMAP.md: ``fit_stream``
(the host-tier cache) and the sharded ``train.mesh`` tier.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.ops.distance import DistanceMeasure
from flink_ml_tpu_torch.params.param import ParamValidators, StringParam, update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasK,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from flink_ml_tpu_torch.servable.lib import KMeansModelServable, kmeans_predict

__all__ = ["KMeans", "KMeansModel"]

_NOT_PORTED = "is not ported to the PyTorch package yet (see ROADMAP.md)"


def _assign_partials(measure: DistanceMeasure, k: int, centroids: torch.Tensor,
                     X: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closest centroid of every row, then the per-centroid sums of the
    rows ``one_hot(assign)ᵀ @ X`` [k, d] and the counts [k]."""
    assign = measure.find_closest(X, centroids)
    hot = (assign[:, None] == torch.arange(k, device=X.device)).to(X.dtype) * mask[:, None]
    return hot.T @ X, torch.sum(hot, dim=0)


def _epoch_update(measure: DistanceMeasure, k: int, centroids: torch.Tensor,
                  X: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch: the new centroids (sum / count, the old centroid where the
    count is 0) and the counts."""
    sums, counts = _assign_partials(measure, k, centroids, X, mask)
    safe = torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centroids), counts


def _train_loop(measure_name: str, k: int, n_epochs: int, centroids: torch.Tensor,
                X: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_epochs`` epochs from ``centroids``: ``(centroids, counts of the
    last epoch)``, both left on the device."""
    measure = DistanceMeasure.get_instance(measure_name)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device)
    for _ in range(n_epochs):
        centroids, counts = _epoch_update(measure, k, centroids, X, mask)
    return centroids, counts


class KMeansModel(ModelArraysMixin, Model, HasFeaturesCol, HasPredictionCol, HasDistanceMeasure, HasK):
    """prediction = the index of the closest centroid."""

    _MODEL_ARRAY_NAMES = ("centroids", "weights")

    def __init__(self):
        super().__init__()
        self.centroids = None  # [k, d]
        self.weights = None  # [k]

    def transform(self, *inputs, device=None):
        """The prediction column (DOUBLE) on ``device`` (None → the GPU)."""
        (df,) = inputs
        if self.centroids is None:
            raise RuntimeError("model must be fit/loaded before transform")
        pred = kmeans_predict(df.vectors(self.get_features_col()), self.centroids,
                              self.get_distance_measure(), resolve_device(device))
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        return out

    @classmethod
    def load_servable(cls, path: str) -> KMeansModelServable:
        """The runtime-free servable of this model's save directory."""
        return KMeansModelServable.load_servable(path)


class KMeans(Estimator, HasFeaturesCol, HasPredictionCol, HasDistanceMeasure, HasK, HasSeed, HasMaxIter):
    """Lloyd's k-means for ``maxIter`` epochs on one device."""

    INIT_MODE = StringParam(
        "initMode",
        "The initialization algorithm. Supported options: 'random'.",
        "random",
        ParamValidators.in_array(["random"]),
    )

    def get_init_mode(self) -> str:
        return self.get(self.INIT_MODE)

    def set_init_mode(self, value: str):
        return self.set(self.INIT_MODE, value)

    def fit(self, *inputs, device=None) -> KMeansModel:
        """Cluster the features column on ``device`` (None → the GPU)."""
        (df,) = inputs
        X = df.vectors(self.get_features_col()).astype(np.float32)
        self._check_rows(X.shape[0])  # before anything reaches the device
        return self.fit_cache(DeviceDataCache({"x": X}, device=device))

    def fit_cache(self, cache: DeviceDataCache) -> KMeansModel:
        """The resident fit on ``cache``'s column ``x`` [n, d] float32."""
        from flink_ml_tpu_torch.config import Options, config

        if config.get(Options.TRAIN_MESH):
            raise NotImplementedError(f"train.mesh is set: sharded KMeans training {_NOT_PORTED}")
        k = self.get_k()
        self._check_rows(cache.n_valid)
        resolve_device(cache.device)  # float32 products stay in full float32 (TF32 off)
        pick = np.random.default_rng(self.get_seed()).choice(cache.n_valid, size=k, replace=False)
        X = cache["x"]
        init = X[torch.from_numpy(pick).to(X.device)]
        with torch.no_grad():
            centroids, counts = _train_loop(self.get_distance_measure(), k, self.get_max_iter(),
                                            init, X, cache.mask)
        model = KMeansModel()
        update_existing_params(model, self)
        model.centroids = centroids.cpu().numpy().astype(np.float64)
        model.weights = counts.cpu().numpy().astype(np.float64)
        return model

    def _check_rows(self, n: int) -> None:
        if n < self.get_k():
            raise ValueError(f"KMeans needs at least k={self.get_k()} points, got {n}")

    def fit_stream(self, cache, chunk_rows: int = 65_536, checkpoint_manager=None,
                   checkpoint_interval: int = 0, listeners=()) -> KMeansModel:
        raise NotImplementedError(f"KMeans.fit_stream (a host-tier cache) {_NOT_PORTED}")
