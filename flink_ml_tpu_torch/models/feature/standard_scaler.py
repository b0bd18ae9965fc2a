"""StandardScaler (batch) and OnlineStandardScaler (windowed, versioned) —
twin of ``flink_ml_tpu/models/feature/standard_scaler.py``.

fit: the masked column statistics on the device in float32 — the mean, and
the *centered* second moment Σ mask·(x − mean)², so |mean| ≫ std does not
cancel — finalized on the host in float64 as std = sqrt(Σ/(n − 1)), 0 when
n == 1 (``StandardScaler.java``). transform subtracts the mean if withMean
and multiplies by 1/std (0 for a zero std) if withStd
(``StandardScalerModel.java:60-97``), through the same servable math the
serving path runs.

The online half (``OnlineStandardScaler.java``,
``OnlineStandardScalerModel.java``): one model version per window, over
sums, squared sums and counts kept on the host in float64 across windows
(:func:`_mean_std`, the JAX package's formula, so both packages give the
same bits), versions counted from 0. The model's timestamp is its last
window's largest event time. Model-delay gating
(``OnlineStandardScalerModel.processElement1``): a row of event time ``t``
is served only by a version with ``t − maxAllowedModelDelayMs ≤
modelTimestamp``; ``transform`` serves each row with the earliest such
version, pulling versions from the training stream as it needs them, and
buffers rows no version can serve yet (``pending``, the
``bufferedPointsState`` role) for a later ``serve_pending()``. The scaling
itself runs on the card, through the batch model's servable.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.iteration.stream import split_by_tumbling_window, window_stream
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.models.online import HasCheckpointing, OnlineModelBase, SnapshotDriver, as_batch_stream
from flink_ml_tpu_torch.ops.windows import EventTimeTumblingWindows
from flink_ml_tpu_torch.params.param import BoolParam, update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasInputCol,
    HasMaxAllowedModelDelayMs,
    HasModelVersionCol,
    HasOutputCol,
    HasWindows,
)
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import StandardScalerModelServable
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = [
    "StandardScaler",
    "StandardScalerModel",
    "OnlineStandardScaler",
    "OnlineStandardScalerModel",
    "TIMESTAMP_COL",
]


class _ScalerParams(HasInputCol, HasOutputCol):
    """StandardScalerParams — withMean (false), withStd (true)."""

    WITH_MEAN = BoolParam("withMean", "Whether centers the data with mean before scaling.", False)
    WITH_STD = BoolParam("withStd", "Whether scales the data with standard deviation.", True)

    def get_with_mean(self) -> bool:
        return self.get(self.WITH_MEAN)

    def set_with_mean(self, value: bool):
        return self.set(self.WITH_MEAN, value)

    def get_with_std(self) -> bool:
        return self.get(self.WITH_STD)

    def set_with_std(self, value: bool):
        return self.set(self.WITH_STD, value)


def _mean_std(sum_: np.ndarray, sq_sum: np.ndarray, n: float):
    """mean/std from [sum, squaredSum, count] (BuildModelOperator.endInput):
    std = sqrt((sqSum − n·mean²)/(n − 1)), 0 when n == 1."""
    mean = sum_ / n
    if n > 1:
        var = (sq_sum - n * mean * mean) / (n - 1)
        std = np.sqrt(np.maximum(var, 0.0))
    else:
        std = np.zeros_like(mean)
    return mean, std


def _stats(X: torch.Tensor, mask: torch.Tensor):
    """Masked mean, centered second moment and row count, float32."""
    n = torch.sum(mask)
    mean = torch.sum(X * mask[:, None], dim=0) / torch.clamp(n, min=1.0)
    c = (X - mean[None, :]) * mask[:, None]
    return mean, torch.sum(c * c, dim=0), n


class StandardScalerModel(ModelArraysMixin, Model, _ScalerParams):
    """StandardScalerModel.java: ``mean`` and ``std`` (float64 [d])."""

    _MODEL_ARRAY_NAMES = ("mean", "std")

    def __init__(self):
        super().__init__()
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    @classmethod
    def load_servable(cls, path: str) -> StandardScalerModelServable:
        """The runtime-free servable of this model's save directory."""
        return StandardScalerModelServable.load_servable(path)

    def _servable(self) -> StandardScalerModelServable:
        if self.mean is None:
            raise RuntimeError("model must be fit/loaded before transform or kernel_spec")
        servable = StandardScalerModelServable()
        update_existing_params(servable, self)
        servable.mean, servable.std = self.mean, self.std
        return servable

    def transform(self, *inputs, device=None):
        """The scaled column on ``device`` (None → the GPU): the servable's
        float32 math, read back as float64."""
        (df,) = inputs
        return self._servable().transform(df, device=device)

    def kernel_spec(self) -> KernelSpec:
        """Standardization as a fusable spec — the servable's."""
        return self._servable().kernel_spec()


class StandardScaler(Estimator, _ScalerParams):
    """StandardScaler.java."""

    def fit(self, *inputs, device=None) -> StandardScalerModel:
        """The column statistics on ``device`` (None → the GPU)."""
        (df,) = inputs
        if len(df) == 0:
            raise RuntimeError("The training set is empty.")
        dev = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(df.vectors(self.get_input_col()), np.float32)).to(dev)
        # One device holds every row: the mask is all ones (the JAX cache
        # pads shards to equal length and masks the padding out).
        mean, sq_c, n = _stats(X, torch.ones(X.shape[0], dtype=torch.float32, device=dev))
        mean = mean.cpu().numpy().astype(np.float64)
        n = float(n)
        if n > 1:
            std = np.sqrt(np.maximum(sq_c.cpu().numpy().astype(np.float64) / (n - 1), 0.0))
        else:
            std = np.zeros_like(mean)
        model = StandardScalerModel()
        update_existing_params(model, self)
        model.mean, model.std = mean, std
        return model


TIMESTAMP_COL = "__timestamp__"  # the event-time column (windows and delay gating)


def _concat_frames(frames):
    """Row-concatenate DataFrames of one schema."""
    return frames[0] if len(frames) == 1 else DataFrame.concat(frames)


class OnlineStandardScalerModel(OnlineModelBase, _ScalerParams, HasModelVersionCol, HasMaxAllowedModelDelayMs):
    """OnlineStandardScalerModel.java: versioned serving, gauges, and the
    row-wise gate of ``maxAllowedModelDelayMs`` on event time."""

    _MODEL_ARRAY_NAMES = ("mean", "std")

    def __init__(self):
        super().__init__()
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.model_timestamp: float = float("-inf")
        self._pending: list = []  # the bufferedPointsState role

    def _apply_snapshot(self, payload) -> None:
        mean, std, ts = payload
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self.model_timestamp = float(ts)

    def _serve(self, df: DataFrame, device) -> DataFrame:
        servable = StandardScalerModelServable()
        update_existing_params(servable, self)
        servable.mean, servable.std = self.mean, self.std
        out = servable.transform(df, device=device)
        out.add_column(self.get_model_version_col(), DataTypes.LONG,
                       np.full(len(df), self.model_version, np.int64))
        return out

    @property
    def pending_rows(self) -> int:
        """Rows buffered because no fresh enough version has arrived."""
        return sum(len(f) for f in self._pending)

    # buffered rows are state (bufferedPointsState is part of the reference
    # operator's checkpoint): they survive save and load
    def save(self, path: str) -> None:
        super().save(path)
        for i, frame in enumerate(self._pending):
            cols = {}
            for name in frame.get_column_names():
                col = frame.column(name)
                if isinstance(col, np.ndarray):
                    cols[name] = col
                else:  # a list column (SparseVector cells): the objects, not a densified array
                    arr = np.empty(len(col), dtype=object)
                    arr[:] = col
                    cols[name] = arr
            rw.save_column_arrays(os.path.join(path, f"pending{i}.npz"), cols)

    @classmethod
    def load(cls, path: str):
        model = super().load(path)
        i = 0
        while os.path.exists(os.path.join(path, f"pending{i}.npz")):
            cols = rw.load_column_arrays(os.path.join(path, f"pending{i}.npz"))
            model._pending.append(DataFrame(
                list(cols), None, [list(c) if c.dtype == object else c for c in cols.values()]))
            i += 1
        return model

    def serve_pending(self, device=None) -> Optional[DataFrame]:
        """Serve the buffered rows that new versions made servable, on
        ``device`` (None → the GPU); None when none became servable."""
        if not self._pending:
            return None
        buffered, self._pending = self._pending, []
        outs = [self.transform(f, device=device) for f in buffered]
        outs = [o for o in outs if len(o)]
        return _concat_frames(outs) if outs else None

    def transform(self, *inputs, device=None):
        """The scaled rows this model may serve, each by the earliest fresh
        enough version, in input order, scaled on ``device`` (None → the
        GPU); the rest are buffered. Without an event-time column every row
        is served."""
        (df,) = inputs
        if self.mean is None:
            raise RuntimeError("no model version has arrived yet; advance() the model")
        dev = resolve_device(device)
        if TIMESTAMP_COL not in df.get_column_names():
            return self._serve(df, dev)
        delay = float(self.get_max_allowed_model_delay_ms())
        ts = df.scalars(TIMESTAMP_COL)
        remaining = np.arange(len(df))
        parts = []
        while remaining.size:
            servable = ts[remaining] - delay <= self.model_timestamp
            if servable.any():
                idx = remaining[servable]
                parts.append((idx, self._serve(df.take(idx), dev)))
                remaining = remaining[~servable]
            if not remaining.size:
                break
            if self.advance(1) == 0:
                # the training stream is dry or ended: buffer the too-new rows
                self._pending.append(df.take(remaining))
                break
        if not parts:  # nothing servable yet: no rows, the output's schema
            return self._serve(df.take(np.asarray([], np.int64)), dev)
        order = np.argsort(np.concatenate([idx for idx, _ in parts]), kind="stable")
        return _concat_frames([out for _, out in parts]).take(order)


class OnlineStandardScaler(Estimator, _ScalerParams, HasWindows, HasModelVersionCol, HasMaxAllowedModelDelayMs,
                           HasCheckpointing):
    """OnlineStandardScaler.java: one version per window over the
    cumulative statistics, versions from 0 (the reference emits the model
    that includes the window, numbered before the increment)."""

    TIMESTAMP_COL = TIMESTAMP_COL

    def fit(self, *inputs) -> OnlineStandardScalerModel:
        """The online model over ``inputs[0]`` (a DataFrame, windowed and
        trained at once, or any stream of batches, trained by
        ``advance``). The statistics are host float64."""
        (data,) = inputs
        input_col = self.get_input_col()
        windows = self.get_windows()

        stream, bounded = as_batch_stream(data, None)
        if bounded:
            windowed = window_stream(stream, windows, timestamp_column=self.TIMESTAMP_COL)
        elif isinstance(windows, EventTimeTumblingWindows):
            # window_stream is a generator, which a StreamDry from a fed
            # stream would end: event-time batches are split window by
            # window by an object that survives it
            windowed = _BatchWindowSplitter(stream, windows.size_ms, self.TIMESTAMP_COL)
        else:
            # count, processing-time and global windows on a fed stream: each
            # added batch is one window (the feeding defines the boundaries)
            windowed = stream

        def train_step(state, batch):
            s, sq, n = state
            X = np.asarray(batch[input_col], np.float64)
            if X.ndim == 1:
                X = X[:, None]
            if s is None:
                s = np.zeros(X.shape[1])
                sq = np.zeros(X.shape[1])
            s = s + X.sum(axis=0)
            sq = sq + (X * X).sum(axis=0)
            n = n + X.shape[0]
            mean, std = _mean_std(s, sq, n)
            # the model's timestamp is its window's largest event time
            # (StandardScalerModelData.timestamp); without event time it is
            # always fresh
            ts_col = batch.get(TIMESTAMP_COL)
            w_ts = float(np.max(ts_col)) if ts_col is not None and len(ts_col) else float("inf")
            return (s, sq, n), (mean, std, w_ts)

        # the payload's window timestamp is not in the state: snapshots keep it
        driver = self._snapshot_driver(windowed, train_step, (None, None, 0))
        model = OnlineStandardScalerModel()
        update_existing_params(model, self)
        model.model_version = -1  # the first version is 0
        driver.resume_into(model, version_offset=-1)
        model._attach_stream(_VersionFromZero(driver))
        if bounded:
            model.advance()
        return model


class _BatchWindowSplitter:
    """Each arriving batch split into its tumbling windows, in window
    order. A plain object, not a generator, so a ``StreamDry`` from a fed
    stream passes through it; windows never merge across added batches
    (each batch is taken as complete up to its watermark)."""

    def __init__(self, stream, size_ms: float, ts_col: str):
        self._stream = stream
        self._size = size_ms
        self._ts_col = ts_col
        self._queue: list = []

    def __iter__(self):
        return self

    def __next__(self):
        while not self._queue:
            batch = next(self._stream)  # may raise StopIteration or StreamDry
            ts = batch.get(self._ts_col)
            if ts is None:
                return batch
            self._queue.extend(part for _, part in split_by_tumbling_window(batch, self._size, ts))
        return self._queue.pop(0)


class _VersionFromZero:
    """The driver counts versions from 1, OnlineStandardScaler from 0."""

    def __init__(self, driver: SnapshotDriver):
        self._driver = driver

    def __iter__(self):
        return self

    def __next__(self):
        version, payload = next(self._driver)
        return version - 1, payload
