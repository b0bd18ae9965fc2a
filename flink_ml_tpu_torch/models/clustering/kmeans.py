"""K-means clustering — twin of ``flink_ml_tpu/models/clustering/kmeans.py``
on one device or a mesh.

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

On ``train.mesh`` (JAX :263-275) every rank is handed the whole input and
the fit runs the deterministic tier: the points dealt block-cyclically
(``TrainSharding.deal_cache``), and per epoch each point's ``[one_hot ·
x | one_hot]`` contribution folded through ``collectives.mapreduce_sum``
(``_sharded_epoch_tot``) before the same update. The closest centroid comes
from distances whose every sum is ``row_fold_sum``'s pairwise fold over d
(``_fixed_order_pairwise``), never a product whose algorithm depends on the
local batch, so an assignment cannot flip with the width: centroids and
counts are bit-identical at every width.

fit_stream (JAX :291): the points replay every epoch from a host-tier cache
(column ``features``; ``HostDataCache``, ``NativeDataCache``) through the
bounded iteration loop's ``ReplayableDataStreamList``, re-chunked into
``chunk_rows``-row device chunks (``iteration/stream.py`` ``rebatch``). Each
chunk's partial sums and counts (``_assign_partials``) are queued and copied
back without waiting; the host waits on a chunk's copy only after the next
chunk is queued, and folds them in float64 (the reference's countWindowAll
reduce). The same seed draws the same initial rows as ``fit``. A checkpoint
manager snapshots ``[centroids]`` every ``checkpoint_interval`` epochs
(fingerprint ``"algo": "KMeans.fit_stream"``); a run resumed at the terminal
epoch recomputes the counts with one streamed pass. On ``train.mesh`` each
chunk is dealt over the ranks (``TrainSharding.deal_cache``) and reduced by
``_sharded_epoch_tot``, the chunk totals added on the device in chunk order:
bit-identical across widths. ``train.mesh.model`` > 1 drops to one card a
rank, as ``fit`` does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.ops.distance import DistanceMeasure
from flink_ml_tpu_torch.parallel.collectives import BLOCK_ROWS, block_partials, fold_partials, row_fold_sum
from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding
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


#: Elements of one chunk of the sharded epoch's ``[rows, k, d]`` tensors;
#: chunks are whole 8-row blocks, so the chunking leaves every bit as it is.
_SHARDED_CHUNK_ELEMENTS = 1 << 24


def _fixed_order_pairwise(measure_name: str, X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[rows, d] × [k, d] → [rows, k] distances, each of the measure's sums
    (``ops/distance.py``'s formulas in their order) taken by ``row_fold_sum``
    over d: a row's distances are the same bits whatever rows surround it."""
    if measure_name == "manhattan":
        return row_fold_sum(torch.abs(X[:, None, :] - C[None, :, :]))
    dots = row_fold_sum(X[:, None, :] * C[None, :, :])
    p2, c2 = row_fold_sum(X * X), row_fold_sum(C * C)
    if measure_name == "euclidean":
        return torch.sqrt(torch.clamp_min(p2[:, None] + c2[None, :] - 2.0 * dots, 0.0))
    if measure_name == "cosine":
        return 1.0 - dots / torch.sqrt(p2)[:, None] / torch.sqrt(c2)[None, :]
    raise ValueError(f"distanceMeasure {measure_name} is not recognized")


def _sharded_epoch_tot(measure_name: str, k: int, centroids: torch.Tensor, X: torch.Tensor,
                       mask: torch.Tensor, ctx) -> torch.Tensor:
    """The replicated totals ``[k, d+1]`` of one epoch (``tot[:, :-1]``
    sums, ``tot[:, -1]`` counts): each point's ``[one_hot·x | one_hot]``
    folded by ``mapreduce_sum`` — bit-identical at every width for the same
    global point order. The rank's rows go through in chunks of whole 8-row
    blocks, so ``[rows, k, d + 1]`` is bounded."""
    rows, d = X.shape
    step = max(BLOCK_ROWS, _SHARDED_CHUNK_ELEMENTS // max(1, k * (d + 1)) // BLOCK_ROWS * BLOCK_ROWS)
    arange = torch.arange(k, device=X.device)
    parts = []
    for r0 in range(0, rows, step):
        x, m = X[r0:r0 + step], mask[r0:r0 + step]
        assign = torch.argmin(_fixed_order_pairwise(measure_name, x, centroids), dim=1)
        hot = (assign[:, None] == arange).to(X.dtype) * m[:, None]
        aug = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        parts.append(block_partials(hot[:, :, None] * aug[:, None, :]))
    return fold_partials(torch.cat(parts), ctx)


def _tot_update(tot: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The centroid update from the totals: ``_epoch_update``'s rule."""
    sums, counts = tot[:, :-1], tot[:, -1]
    safe = torch.clamp_min(counts, 1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centroids), counts


def _sharded_train_loop(measure_name: str, k: int, n_epochs: int, centroids: torch.Tensor,
                        X: torch.Tensor, mask: torch.Tensor, ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic tier's ``_train_loop``: ``n_epochs`` epochs through
    ``_sharded_epoch_tot``, the same on every rank."""
    counts = torch.zeros(k, dtype=X.dtype, device=X.device)
    for _ in range(n_epochs):
        centroids, counts = _tot_update(_sharded_epoch_tot(measure_name, k, centroids, X, mask, ctx),
                                        centroids)
    return centroids, counts


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
        """Cluster the features column on ``device`` (None → the GPU; on a
        mesh, this rank's card)."""
        (df,) = inputs
        X = df.vectors(self.get_features_col()).astype(np.float32)
        self._check_rows(X.shape[0])  # before anything reaches the device
        ts = resolve_train_sharding(device)
        if ts is not None and ts.n_model == 1:
            return self._fit_sharded(X, ts)
        if ts is not None:
            # the deterministic tier is data-parallel only (JAX kmeans.py:323):
            # on a tensor-parallel mesh every rank fits the whole input on
            # its own card, each to the same centroids
            device = ts.ctx.device
        return self.fit_cache(DeviceDataCache({"x": X}, device=device))

    def _initial_rows(self, n: int) -> np.ndarray:
        """The random-sample init (``KMeans.selectRandomCentroids``): ``k``
        row indices drawn on the host as the JAX package draws them."""
        return np.random.default_rng(self.get_seed()).choice(n, size=self.get_k(), replace=False)

    def _fit_sharded(self, X: np.ndarray, ts) -> KMeansModel:
        """The deterministic tier: the points dealt over ``ts``'s ranks and
        every epoch reduced by the mapreduce tier."""
        k = self.get_k()
        cache = ts.deal_cache({"x": X})
        init = ts.replicate(X[self._initial_rows(X.shape[0])])
        with torch.no_grad():
            centroids, counts = _sharded_train_loop(self.get_distance_measure(), k, self.get_max_iter(),
                                                    init, cache["x"], cache.mask, ts.ctx)
        metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        return self._model(centroids, counts)

    def _model(self, centroids: torch.Tensor, counts: torch.Tensor) -> KMeansModel:
        model = KMeansModel()
        update_existing_params(model, self)
        model.centroids = centroids.cpu().numpy().astype(np.float64)
        model.weights = counts.cpu().numpy().astype(np.float64)
        return model

    def fit_cache(self, cache: DeviceDataCache) -> KMeansModel:
        """The resident single-device fit on ``cache``'s column ``x`` [n, d]
        float32 (``fit`` takes the sharded tier under ``train.mesh``)."""
        k = self.get_k()
        self._check_rows(cache.n_valid)
        resolve_device(cache.device)  # float32 products stay in full float32 (TF32 off)
        X = cache["x"]
        init = X[torch.from_numpy(self._initial_rows(cache.n_valid)).to(X.device)]
        with torch.no_grad():
            centroids, counts = _train_loop(self.get_distance_measure(), k, self.get_max_iter(),
                                            init, X, cache.mask)
        return self._model(centroids, counts)

    def _check_rows(self, n: int) -> None:
        if n < self.get_k():
            raise ValueError(f"KMeans needs at least k={self.get_k()} points, got {n}")

    def fit_stream(self, cache, chunk_rows: int = 65_536, checkpoint_manager=None,
                   checkpoint_interval: int = 0, listeners=(), device=None) -> KMeansModel:
        """KMeans on a host-tier cache larger than the card, on ``device``
        (None → the GPU; on a mesh, this rank's card). ``checkpoint_manager``
        and ``checkpoint_interval`` give it SGD's kill/resume contract: the
        snapshot is ``(epoch, [centroids])`` and a rerun resumes at the last
        snapshotted epoch and lands on the same model."""
        import hashlib
        import json

        from flink_ml_tpu_torch.iteration import (
            IterationBodyResult,
            IterationConfig,
            ReplayableDataStreamList,
            iterate_bounded_until_termination,
        )
        from flink_ml_tpu_torch.iteration.stream import rebatch

        ts = resolve_train_sharding(device)
        if ts is not None and ts.n_model != 1:
            device, ts = ts.ctx.device, None  # the deterministic tier is data-parallel only
        k = self.get_k()
        n = int(cache.num_rows)
        self._check_rows(n)
        init = np.concatenate([np.asarray(cache.rows(int(i), int(i) + 1)["features"], np.float32)
                               for i in self._initial_rows(n)])
        if checkpoint_manager is not None:
            sig = {"algo": "KMeans.fit_stream", "k": k, "seed": self.get_seed(), "max_iter": self.get_max_iter(),
                   "distance": self.get_distance_measure(), "rows": n, "dim": int(init.shape[1])}
            if ts is not None:
                # the deterministic tier is width-invariant: the fingerprint
                # names the tier, so a run resumes at another width
                sig["tier"] = "deterministic"
            checkpoint_manager.set_fingerprint(
                hashlib.sha256(json.dumps(sig, sort_keys=True).encode()).hexdigest()[:16])
        measure_name = self.get_distance_measure()
        measure = DistanceMeasure.get_instance(measure_name)
        dev = ts.ctx.device if ts is not None else resolve_device(device)
        final_counts = np.zeros(k, np.float64)

        def sharded_tot(centroids, points) -> np.ndarray:
            """One deterministic epoch's ``[k, d+1]`` totals: each chunk
            dealt and folded by the mapreduce tier, the chunk totals added
            on the device in chunk order, read once."""
            c_dev = ts.replicate(np.asarray(centroids, np.float32))
            total = None
            with torch.no_grad():
                for chunk in rebatch(points, chunk_rows):
                    window = ts.deal_cache({"x": np.asarray(chunk["features"], np.float32)})
                    tot = _sharded_epoch_tot(measure_name, k, c_dev, window["x"], window.mask, ts.ctx)
                    total = tot if total is None else total + tot
            return total.cpu().numpy().astype(np.float32)

        def host_fold(centroids, points) -> Tuple[np.ndarray, np.ndarray]:
            """One epoch's float64 sums and counts: chunk i's partials are
            queued and their copy back issued, then chunk i - 1's are waited
            for and folded, so the next chunk's upload and kernels are queued
            before the host waits."""
            c_dev = torch.from_numpy(np.asarray(centroids, np.float32)).to(dev)
            sums = np.zeros((k, init.shape[1]), np.float64)
            counts = np.zeros(k, np.float64)
            prev = None
            with torch.no_grad():
                for chunk in rebatch(points, chunk_rows):
                    x = _to_device(chunk["features"], dev)
                    issued = _to_host(_assign_partials(measure, k, c_dev, x, torch.ones_like(x[:, 0])))
                    if prev is not None:
                        s_, c_ = prev()
                        sums += s_
                        counts += c_
                    prev = issued
            if prev is not None:
                s_, c_ = prev()
                sums += s_
                counts += c_
            return sums, counts

        def body(variables, epoch, streams):
            nonlocal final_counts
            (centroids,) = variables
            if ts is not None:
                tot = sharded_tot(centroids, streams["points"])
                sums, counts = tot[:, :-1], tot[:, -1]
                new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None],
                               np.asarray(centroids, np.float32)).astype(np.float32)
            else:
                sums, counts = host_fold(centroids, streams["points"])
                new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None],
                               centroids).astype(np.float32)
            final_counts = counts.astype(np.float64)
            return IterationBodyResult([new], outputs=[new])

        outputs = iterate_bounded_until_termination(
            [init], body,
            config=IterationConfig(max_epochs=self.get_max_iter(), checkpoint_manager=checkpoint_manager,
                                   checkpoint_interval=checkpoint_interval),
            data=ReplayableDataStreamList(replay={"points": cache}), listeners=listeners,
        )
        if outputs:
            (centroids,) = outputs
        else:
            # resumed at the terminal epoch: the body never ran, so the
            # snapshot is the final model; one streamed pass recounts
            _, (centroids,) = checkpoint_manager.restore_latest()
            centroids = np.asarray(centroids)
            if ts is not None:
                final_counts = sharded_tot(centroids, cache.iter_rows())[:, -1].astype(np.float64)
            else:
                final_counts = host_fold(centroids, cache.iter_rows())[1]
        if ts is not None:
            metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        model = KMeansModel()
        update_existing_params(model, self)
        model.centroids = np.asarray(centroids, np.float64)
        model.weights = np.asarray(final_counts, np.float64)
        return model


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: copied out first when it is read-only (a
    spill file's memory map), then on CUDA pinned and copied without
    waiting."""
    t = torch.from_numpy(np.require(arr, np.float32, ["C", "W"]))
    return t if device.type == "cpu" else t.pin_memory().to(device, non_blocking=True)


def _to_host(tensors):
    """Issue the copy of ``tensors`` back to the host without waiting;
    returns a callable that waits for it and gives them as float64 arrays."""
    if tensors[0].device.type == "cpu":
        return lambda: tuple(t.numpy().astype(np.float64) for t in tensors)
    hosts = []
    for t in tensors:
        host = torch.empty(tuple(t.shape), dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    copied = torch.cuda.Event()
    copied.record()

    def wait():
        copied.synchronize()
        return tuple(h.numpy().astype(np.float64) for h in hosts)

    return wait
