"""Online k-means with decayed centroid updates — twin of
``flink_ml_tpu/models/clustering/online_kmeans.py``.

Reference: ``OnlineKMeans.java`` — per global batch
(``ModelDataLocalUpdater.alignAndComputeModelData:200-254``): each point
goes to its closest centroid; the old weights decay by ``decayFactor``; for
each cluster that got points

    weight_i ← weight_i·decay + count_i
    centroid_i ← (1 − λ)·centroid_i + λ·mean(points_i),  λ = count_i / weight_i

and a cluster with none keeps its centroid (and its decayed weight).
``OnlineKMeansModel`` predicts the closest centroid with the newest version.

The step runs on the estimator's device in float32: the assignment
(``ops/distance.py``), the counts and sums as ``one_hot(assign)ᵀ @ X``
(``kmeans.py`` ``_assign_partials``), then the decay and blend
(:func:`_blend`). On ``train.mesh`` (JAX :171-199) each batch is dealt over
the ranks (``TrainSharding.deal_cache``) and reduced by the deterministic
tier (``kmeans.py`` ``_sharded_epoch_tot``) before the same blend, so every
version is bit-identical at every width; a model axis past 1 drops to the
one-device step on each rank's card, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.clustering.kmeans import _assign_partials, _sharded_epoch_tot
from flink_ml_tpu_torch.models.online import HasCheckpointing, OnlineModelBase, array_digest, as_batch_stream
from flink_ml_tpu_torch.ops.distance import DistanceMeasure
from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding
from flink_ml_tpu_torch.params.param import update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasBatchStrategy,
    HasDecayFactor,
    HasDistanceMeasure,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasK,
    HasPredictionCol,
    HasSeed,
)
from flink_ml_tpu_torch.servable.lib import kmeans_predict

__all__ = ["OnlineKMeans", "OnlineKMeansModel"]


def _blend(centroids: torch.Tensor, weights: torch.Tensor, sums: torch.Tensor, counts: torch.Tensor,
           decay: float):
    """The decay and blend of one batch's sums [k, d] and counts [k]:
    ``(centroids, weights)`` after it."""
    new_weights = weights * decay + counts
    lam = torch.where(new_weights > 0, counts / torch.clamp_min(new_weights, 1e-16), 0.0)
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    blended = (1.0 - lam[:, None]) * centroids + lam[:, None] * means
    return torch.where(counts[:, None] > 0, blended, centroids), new_weights


class OnlineKMeansModel(OnlineModelBase, HasFeaturesCol, HasPredictionCol, HasDistanceMeasure, HasK):
    """OnlineKMeansModel.java."""

    _MODEL_ARRAY_NAMES = ("centroids", "weights")

    def __init__(self):
        super().__init__()
        self.centroids: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None

    def _apply_snapshot(self, payload) -> None:
        self.centroids, self.weights = (np.asarray(a) for a in payload)

    def transform(self, *inputs, device=None):
        """The closest centroid of the newest version (DOUBLE) on
        ``device`` (None → the GPU)."""
        (df,) = inputs
        if self.centroids is None:
            raise RuntimeError("no model version has arrived yet; advance() the model")
        pred = kmeans_predict(df.vectors(self.get_features_col()).astype(np.float32),
                              np.asarray(self.centroids, np.float32), self.get_distance_measure(),
                              resolve_device(device))
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, pred.cpu().numpy().astype(np.float64))
        return out


class OnlineKMeans(
    Estimator,
    HasFeaturesCol,
    HasPredictionCol,
    HasDistanceMeasure,
    HasK,
    HasSeed,
    HasDecayFactor,
    HasGlobalBatchSize,
    HasBatchStrategy,
    HasCheckpointing,
):
    """OnlineKMeans.java: needs an initial model, random or given."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._initial_model: Optional[tuple] = None

    def set_initial_model_data(self, model_data: DataFrame) -> "OnlineKMeans":
        """Initial ``centroids`` and ``weights`` from a model-data DataFrame."""
        centroids = np.asarray(model_data.column("centroids")[0], np.float64)
        weights = np.asarray(model_data.column("weights")[0], np.float64)
        self._initial_model = (centroids, weights)
        return self

    def set_random_initial_model_data(self, dim: int) -> "OnlineKMeans":
        """KMeansModelData.generateRandomModelData: standard normal centroids
        of weight 0, drawn by ``np.random.default_rng(seed)`` as the JAX
        package draws them."""
        rng = np.random.default_rng(self.get_seed())
        k = self.get_k()
        self._initial_model = (rng.normal(size=(k, dim)), np.zeros(k))
        return self

    def fit(self, *inputs, device=None) -> OnlineKMeansModel:
        """The online model over ``inputs[0]`` (a DataFrame, trained at once,
        or any stream of batches, trained by ``advance``), its steps on
        ``device`` (None → the GPU; on ``train.mesh``, this rank's card)."""
        (data,) = inputs
        if self._initial_model is None:
            raise RuntimeError("OnlineKMeans requires initial model data")
        k = self.get_k()
        centroids0, weights0 = self._initial_model
        if centroids0.shape[0] != k:
            raise ValueError(f"initial model has {centroids0.shape[0]} centroids, k={k}")
        features_col = self.get_features_col()
        measure_name, decay = self.get_distance_measure(), self.get_decay_factor()
        stream, bounded = as_batch_stream(data, self.get_global_batch_size())

        ts = resolve_train_sharding(device)
        if ts is not None and ts.n_model != 1:
            # the deterministic tier is data-parallel only: every rank runs
            # the one-device step on its own card
            device, ts = ts.ctx.device, None
        if ts is not None:
            dev = ts.ctx.device

            def train_step(state, batch):
                centroids, weights = state
                window = ts.deal_cache({"x": np.asarray(batch[features_col], np.float32)})
                with torch.no_grad():
                    tot = _sharded_epoch_tot(measure_name, k, centroids, window["x"], window.mask, ts.ctx)
                    centroids, weights = _blend(centroids, weights, tot[:, :-1], tot[:, -1], decay)
                return (centroids, weights), (centroids.cpu().numpy(), weights.cpu().numpy())

            metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        else:
            dev = resolve_device(device)
            measure = DistanceMeasure.get_instance(measure_name)

            def train_step(state, batch):
                centroids, weights = state
                X = torch.from_numpy(np.ascontiguousarray(batch[features_col], np.float32)).to(dev)
                with torch.no_grad():
                    sums, counts = _assign_partials(measure, k, centroids, X, torch.ones_like(X[:, 0]))
                    centroids, weights = _blend(centroids, weights, sums, counts, decay)
                return (centroids, weights), (centroids.cpu().numpy(), weights.cpu().numpy())

        def place_state(state):  # a JAX-written snapshot holds arrays
            return tuple(torch.as_tensor(x, dtype=torch.float32, device=dev) for x in state)

        driver = self._snapshot_driver(
            stream,
            train_step,
            place_state((np.asarray(centroids0, np.float32), np.asarray(weights0, np.float32))),
            payload_from_state=lambda s: (s[0].cpu().numpy(), s[1].cpu().numpy()),
            place_state=place_state,
            device=dev,
            dim=int(centroids0.shape[1]),
            init=array_digest(centroids0, weights0),
        )
        model = OnlineKMeansModel()
        update_existing_params(model, self)
        model._apply_snapshot((centroids0, weights0))  # version 0: the initial model
        driver.resume_into(model)  # the checkpointed version, if any
        model._attach_stream(driver)
        if bounded:
            model.advance()
        return model
