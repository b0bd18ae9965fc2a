"""Mini-batch streams, the unbounded-input surface — twin of
``flink_ml_tpu/iteration/stream.py``.

Reference: ``DataStreamUtils.generateBatchData:734`` (online minibatching:
collect ``globalBatchSize`` records, then emit one batch) and the
``Windows`` descriptors (``ops/windows.py``) that cut an unbounded stream
into training windows; ``EndOfStreamWindows.java:36`` is one window.

A batch is a dict of equally long host columns, and a stream any iterator
of them. ``window_stream`` applies a descriptor to a stream,
``batch_stream_from_dataframe`` adapts a bounded DataFrame, and ``rebatch``
re-chunks any stream to fixed-size batches (``KMeans.fit_stream``'s device
chunks, ``HostDataCache.iter_minibatches``). The online estimators
(``models/online.py``) consume these one window a training step.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.ops.windows import (
    CountTumblingWindows,
    EventTimeSessionWindows,
    EventTimeTumblingWindows,
    GlobalWindows,
    ProcessingTimeSessionWindows,
    ProcessingTimeTumblingWindows,
    Windows,
)

__all__ = [
    "Batch",
    "batch_stream_from_dataframe",
    "rebatch",
    "split_by_tumbling_window",
    "window_stream",
]

Batch = Dict[str, np.ndarray]


def _df_to_columns(df: DataFrame, columns: Optional[Sequence[str]] = None) -> Batch:
    names = columns if columns is not None else df.get_column_names()
    out: Batch = {}
    for n in names:
        col = df.column(n)
        out[n] = col if isinstance(col, np.ndarray) else np.asarray(col, dtype=object)
    return out


def _batch_len(batch: Batch) -> int:
    return next(iter(batch.values())).shape[0]


def _slice(batch: Batch, lo: int, hi: int) -> Batch:
    return {k: v[lo:hi] for k, v in batch.items()}


def _concat(chunks: List[Batch]) -> Batch:
    keys = chunks[0].keys()
    return {k: np.concatenate([c[k] for c in chunks]) for k in keys}


def batch_stream_from_dataframe(
    df: DataFrame,
    batch_size: Optional[int] = None,
    columns: Optional[Sequence[str]] = None,
) -> Iterator[Batch]:
    """A bounded DataFrame as a stream of column batches of ``batch_size``
    rows (the whole frame as one batch without a size; nothing when empty)."""
    cols = _df_to_columns(df, columns)
    n = _batch_len(cols) if cols else 0
    if batch_size is None or batch_size >= n:
        if n:
            yield cols
        return
    for lo in range(0, n, batch_size):
        yield _slice(cols, lo, min(lo + batch_size, n))


def rebatch(stream: Iterable[Batch], batch_size: int, drop_last: bool = False) -> Iterator[Batch]:
    """Re-chunk any batch stream into batches of ``batch_size`` rows:
    accumulate until a full batch is there, then emit exactly one; the
    trailing partial batch is emitted unless ``drop_last``."""
    pending: List[Batch] = []
    pending_rows = 0
    for batch in stream:
        pending.append(batch)
        pending_rows += _batch_len(batch)
        while pending_rows >= batch_size:
            taken: Dict[str, List[np.ndarray]] = {}
            need = batch_size
            rest: List[Batch] = []
            for chunk in pending:
                n = _batch_len(chunk)
                if need == 0:
                    rest.append(chunk)
                    continue
                use = min(need, n)
                for k, v in chunk.items():
                    taken.setdefault(k, []).append(v[:use])
                if use < n:
                    rest.append(_slice(chunk, use, n))
                need -= use
            pending = rest
            pending_rows -= batch_size
            yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}
    if pending_rows and not drop_last:
        taken = {}
        for chunk in pending:
            for k, v in chunk.items():
                taken.setdefault(k, []).append(v)
        yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}


def window_stream(
    stream: Iterable[Batch],
    windows: Windows,
    timestamp_column: Optional[str] = None,
    now: Optional[Callable[[], float]] = None,
) -> Iterator[Batch]:
    """Cut a batch stream into the windows ``windows`` describes.

    - GlobalWindows: one window at the end of the stream.
    - CountTumblingWindows(size): ``rebatch(stream, size, drop_last=True)``;
      the reference's count window drops the trailing partial window.
    - EventTimeTumblingWindows(size_ms): rows grouped by
      ``timestamp_column // size_ms``, a window emitted once a row of a
      later one arrives (the stream is taken as time-ordered, as the
      reference takes a watermarked stream).
    - ProcessingTime windows: the same over the arrival time, ``now()`` ms.
    - Session windows: a gap over ``gap_ms`` between consecutive
      timestamps closes a window.
    """
    if isinstance(windows, GlobalWindows):
        chunks: List[Batch] = [b for b in stream if _batch_len(b)]
        if chunks:
            keys = chunks[0].keys()
            yield {k: np.concatenate([c[k] for c in chunks]) for k in keys}
        return

    if isinstance(windows, CountTumblingWindows):
        yield from rebatch(stream, windows.size, drop_last=True)
        return

    if isinstance(windows, (EventTimeTumblingWindows, ProcessingTimeTumblingWindows)):
        get_ts = _timestamp_getter(windows, timestamp_column, now)
        current_id: Optional[int] = None
        pending: List[Batch] = []
        for batch in stream:
            for wid, part in split_by_tumbling_window(batch, windows.size_ms, get_ts(batch)):
                if current_id is None:
                    current_id = wid
                if wid != current_id:
                    yield _concat(pending)
                    pending = []
                    current_id = wid
                pending.append(part)
        if pending:
            yield _concat(pending)
        return

    if isinstance(windows, (EventTimeSessionWindows, ProcessingTimeSessionWindows)):
        gap = windows.gap_ms
        get_ts = _timestamp_getter(windows, timestamp_column, now)
        pending = []
        last_ts: Optional[float] = None
        for batch in stream:
            ts = get_ts(batch)
            start = 0
            for i in range(len(ts)):
                if last_ts is not None and ts[i] - last_ts > gap:
                    part = _slice(batch, start, i)
                    if _batch_len(part):
                        pending.append(part)
                    if pending:
                        yield _concat(pending)
                    pending = []
                    start = i
                last_ts = float(ts[i])
            part = _slice(batch, start, len(ts))
            if _batch_len(part):
                pending.append(part)
        if pending:
            yield _concat(pending)
        return

    raise ValueError(f"Unsupported windows descriptor: {windows!r}")


def split_by_tumbling_window(batch: Batch, size_ms: float, ts) -> Iterator[tuple]:
    """``(window id, sub-batch)`` for each tumbling window of ``size_ms``
    present in one batch, in window order: the one place window ids are
    assigned (``window_stream`` and the online scaler's splitter)."""
    ids = (np.asarray(ts) // size_ms).astype(np.int64)
    for wid in np.unique(ids):
        sel = ids == wid
        yield int(wid), {k: np.asarray(v)[sel] for k, v in batch.items()}


def _timestamp_getter(windows, timestamp_column, now):
    if isinstance(windows, (EventTimeTumblingWindows, EventTimeSessionWindows)):
        if not timestamp_column:
            raise ValueError("event-time windows need a timestamp_column")
        return lambda batch: np.asarray(batch[timestamp_column], np.float64)
    import time as _time

    clock = now or (lambda: _time.time() * 1000.0)
    return lambda batch: np.full(_batch_len(batch), clock(), np.float64)
