"""Online (unbounded-stream) estimators and models — twin of
``flink_ml_tpu/models/online.py``.

Reference pattern: an online Estimator's fit wires an
``iterateUnboundedStreams`` dataflow that emits a stream of versioned model
data; the Model holds that stream and serves with whatever version has
arrived, exporting the ``ml.model.version`` gauge.

Here the fitted model owns a :class:`SnapshotDriver`, an iterator of model
snapshots: ``advance(n)`` pulls up to n snapshots (n training windows) and
installs them — the explicit handle on how far training has read the
stream. A bounded input is trained eagerly inside ``fit``; an unbounded one
(any iterator of batches, e.g. :class:`QueueBatchStream`) stays lazy, so a
caller interleaves feeding, training and serving.

Each training step runs on the estimator's device (the GPU unless the
caller passes ``device="cpu"``) and hands the model a host copy of the new
model data: the snapshot a model installs, saves and publishes is host
numpy, as in the JAX package.
"""
from __future__ import annotations

import hashlib
import json
import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

from flink_ml_tpu_torch.api.core import Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.iteration.stream import Batch, batch_stream_from_dataframe, rebatch
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.common import ModelArraysMixin
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = [
    "QueueBatchStream",
    "OnlineModelBase",
    "SnapshotDriver",
    "as_batch_stream",
    "array_digest",
    "HasCheckpointing",
    "online_fingerprint",
]


class QueueBatchStream:
    """An in-memory stream a caller feeds (the InMemorySourceFunction
    analogue): ``add`` column batches or DataFrames, the trainer pulls them,
    and the stream ends once ``close()`` was called and the queue is empty.
    Pulling from an empty open stream raises ``StreamDry`` instead of
    blocking, so one thread can interleave ``add`` and ``advance``."""

    class StreamDry(Exception):
        pass

    def __init__(self):
        self._queue: deque = deque()
        self._closed = False

    def add(self, batch) -> "QueueBatchStream":
        if self._closed:
            raise RuntimeError("stream is closed")
        self._queue.append(batch)
        return self

    def close(self) -> "QueueBatchStream":
        self._closed = True
        return self

    def __iter__(self):
        return self

    def __next__(self):
        while self._queue:
            item = self._queue.popleft()
            if isinstance(item, DataFrame):
                if item.num_rows == 0:
                    continue  # an empty frame is not the end of the stream
                item = next(batch_stream_from_dataframe(item))
            elif item and next(iter(item.values())).shape[0] == 0:
                continue
            return item
        if self._closed:
            raise StopIteration
        raise QueueBatchStream.StreamDry("no batch available; add() more data or close() the stream")


def as_batch_stream(data, batch_size: Optional[int] = None) -> Tuple[Iterator[Batch], bool]:
    """A fit input as ``(batch iterator, is bounded)``. A DataFrame is cut
    into ``batch_size`` batches; another iterable is re-chunked to
    ``batch_size`` by ``rebatch``, except a ``QueueBatchStream``, whose
    batches train as they were added: a ``StreamDry`` raised through
    ``rebatch`` (a generator) would end it for good."""
    if isinstance(data, DataFrame):
        return batch_stream_from_dataframe(data, batch_size), True
    if isinstance(data, QueueBatchStream):
        return data, False
    it = iter(data)
    if batch_size is not None:
        it = rebatch(it, batch_size, drop_last=False)
    return it, False


class HasCheckpointing:
    """Kill and resume for online estimators.

    The reference makes online training recoverable by checkpointing the
    source offsets with the operator state (Checkpoints.java:43-143; SGD's
    batch offset, SGD.java:308-347). Here the estimator hands a
    checkpoint manager to its :class:`SnapshotDriver`, which snapshots the
    version (the count of batches consumed), the training state and, where
    it is not a view of the state, the last payload.

    Resume contract: after a crash, build the estimator again with the same
    params and the same checkpoint directory, and feed a source that
    replays the stream from the beginning (or has ``skip(n)``). The driver
    drops the first ``version`` batches, and training goes on at the next
    unseen batch with the next version: no version reused, none skipped.
    The snapshots are the JAX package's (``online_fingerprint`` is its
    fingerprint), so with either package's ``ShardedCheckpointManager``, a
    run one package started resumes in the other.
    """

    def set_checkpoint(self, manager, interval: int = 1):
        """Install a ``CheckpointManager``, snapshotting every ``interval``
        versions. Returns self."""
        self._checkpoint_manager = manager
        self._checkpoint_interval = interval
        return self

    def _checkpointing(self) -> Tuple[Any, int]:
        return (
            getattr(self, "_checkpoint_manager", None),
            getattr(self, "_checkpoint_interval", 1),
        )

    def _snapshot_driver(self, stream, step_fn, state, payload_from_state=None, place_state=None,
                         device=None, **fingerprint_extra) -> "SnapshotDriver":
        """Install the run's fingerprint on the manager, then build the
        (possibly resuming) driver."""
        mgr, interval = self._checkpointing()
        if mgr is not None:
            mgr.set_fingerprint(online_fingerprint(self, **fingerprint_extra))
        return SnapshotDriver(
            stream,
            step_fn,
            state,
            checkpoint_manager=mgr,
            checkpoint_interval=interval,
            payload_from_state=payload_from_state,
            place_state=place_state,
            device=device,
        )


def online_fingerprint(estimator, **extra) -> str:
    """A run's identity for online checkpoints: a job configured otherwise
    and pointed at the same directory refuses to resume. The JAX package's
    string for the same class name, params and extras."""
    sig = {"class": type(estimator).__name__, "params": estimator.param_map_to_json()}
    sig.update(extra)
    return hashlib.sha256(json.dumps(sig, sort_keys=True, default=str).encode()).hexdigest()


def array_digest(*arrays) -> str:
    """Content hash of initial model arrays for the fingerprint: a run
    started from other initial data is another run."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


class SnapshotDriver:
    """Resumable iterator of ``(version, payload)`` model snapshots.

    One ``__next__`` pulls one batch, runs ``step_fn(state, batch) ->
    (state, payload)`` on it and returns the new version. It is a plain
    object, not a generator, so a ``StreamDry`` from a fed stream reaches
    the caller without ending training: a generator dies on any exception.

    The batch pulled but not yet committed as a version is kept
    (``_inflight``): if the step raises, the next ``__next__`` trains the
    same batch again instead of pulling a fresh one, since a fed source
    cannot replay it.

    With ``checkpoint_manager`` the driver saves ``{"state", "payload"}``
    as step ``version`` every ``checkpoint_interval`` versions (the payload
    only without ``payload_from_state``), and restores the newest snapshot
    when it is built — tensors onto ``device``, then ``place_state`` on the
    state (a snapshot the JAX package wrote holds arrays). The consumed
    offset is skipped lazily, on the first ``__next__`` calls (``skip(n)``
    on a seekable source at once): a fed stream that is still short of the
    prefix raises ``StreamDry`` without losing the position, and one that
    ends inside it raises ``ValueError``.
    """

    def __init__(
        self,
        stream: Iterator[Batch],
        step_fn,
        state: Any,
        checkpoint_manager=None,
        checkpoint_interval: int = 1,
        payload_from_state=None,
        place_state=None,
        device=None,
    ):
        self._stream = stream
        self._step = step_fn
        self.state = state
        self.version = 0
        self._mgr = checkpoint_manager
        self._interval = max(1, int(checkpoint_interval))
        # With payload_from_state a snapshot holds only the state (the
        # payload is a view of it, e.g. the FTRL coefficient).
        self._payload_from_state = payload_from_state
        self._to_skip = 0
        self._inflight: Optional[Batch] = None
        self.resumed = False
        self.restored_payload: Any = None
        if self._mgr is not None:
            restored = self._mgr.restore_latest(device=device)
            if restored is not None:
                # the manager's step is the version is the stream offset
                step, snap = restored
                self.version = int(step)
                self.state = snap["state"] if place_state is None else place_state(snap["state"])
                self.resumed = True
                self.restored_payload = (
                    payload_from_state(self.state) if payload_from_state is not None else snap["payload"]
                )
                self._to_skip = self.version
                if self._to_skip and hasattr(self._stream, "skip"):
                    self._stream.skip(self._to_skip)
                    self._to_skip = 0

    def resume_into(self, model: "OnlineModelBase", version_offset: int = 0) -> None:
        """Install the restored snapshot on ``model`` (nothing on a fresh run)."""
        if self.resumed:
            model._apply_snapshot(self.restored_payload)
            model.model_version = self.version + version_offset

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[int, Any]:
        while self._to_skip > 0:
            try:
                next(self._stream)  # the replayed prefix; may raise StreamDry
            except StopIteration:
                raise ValueError(
                    f"replayed source ended {self._to_skip} batch(es) before the "
                    f"checkpointed offset {self.version}; on resume the source "
                    "must replay the stream from the beginning"
                ) from None
            self._to_skip -= 1
        if self._inflight is None:
            self._inflight = next(self._stream)  # may raise StopIteration or StreamDry
        self.state, payload = self._step(self.state, self._inflight)
        self._inflight = None  # committed: the version counter owns it now
        self.version += 1
        if self._mgr is not None and self.version % self._interval == 0:
            snap = {"state": self.state}
            if self._payload_from_state is None:
                snap["payload"] = payload
            self._mgr.save(self.version, snap)
        return self.version, payload


class OnlineModelBase(ModelArraysMixin, Model):
    """A Model fed by a stream of versioned snapshots. A subclass installs
    one version in ``_apply_snapshot(payload)``; the estimator attaches its
    driver with ``_attach_stream``."""

    #: The wall clock (seconds) behind the ``ml.model.timestamp`` gauge; a
    #: test pins ``model.clock`` to read the gauge without racing time.
    clock: Callable[[], float] = staticmethod(time.time)

    def __init__(self):
        super().__init__()
        self.model_version: int = 0
        self._snapshots: Iterator[Tuple[int, Any]] = iter(())
        self.version_history: List[int] = []

    def _attach_stream(self, snapshots: Iterator[Tuple[int, Any]]) -> None:
        self._snapshots = snapshots

    def _metric_scope(self) -> str:
        return f"{type(self).__name__}@{id(self):x}"

    def _apply_snapshot(self, payload: Any) -> None:
        raise NotImplementedError

    # the model version travels with the model data (the reference's
    # LogisticRegressionModelData(coefficient, modelVersion))
    def save(self, path: str) -> None:
        extra = {"modelVersion": self.model_version}
        # A model gated on event time keeps its freshness across save/load;
        # ±inf survives JSON (Python writes Infinity).
        ts = getattr(self, "model_timestamp", None)
        if ts is not None:
            extra["modelTimestamp"] = float(ts)
        rw.save_metadata(self, path, extra)
        rw.save_model_arrays(path, self._model_arrays())

    @classmethod
    def load(cls, path: str):
        """Load a directory saved by this class or its JAX twin."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        model = cls()
        model.load_param_map_from_json(metadata["paramMap"])
        model._set_model_arrays(rw.load_model_arrays(path))
        model.model_version = metadata.get("modelVersion", 0)
        if hasattr(model, "model_timestamp"):
            # A directory without the field is ungated (+inf): -inf would
            # buffer every timestamped row for good.
            model.model_timestamp = float(metadata.get("modelTimestamp", float("inf")))
        return model

    def advance(self, n: Optional[int] = None, on_snapshot: Optional[Callable[[int, Any], None]] = None) -> int:
        """Install up to ``n`` model snapshots (None: until the stream ends
        or runs dry); returns how many. Each one sets the
        ``ml.model.version`` and ``ml.model.timestamp`` gauges.

        ``on_snapshot(version, payload)`` runs after each snapshot is
        installed (a publisher's seam). An exception from it propagates
        with the snapshot installed and counted, so a retry goes on at the
        next version."""
        applied = 0
        while n is None or applied < n:
            try:
                version, payload = next(self._snapshots)
            except StopIteration:
                break
            except QueueBatchStream.StreamDry:
                break
            self._apply_snapshot(payload)
            self.model_version = version
            self.version_history.append(version)
            scope = self._metric_scope()
            metrics.gauge(scope, MLMetrics.VERSION, version)
            metrics.gauge(scope, MLMetrics.TIMESTAMP, int(self.clock() * 1000))
            applied += 1
            if on_snapshot is not None:
                on_snapshot(version, payload)
        return applied
