"""Dynamic micro-batching — twin of ``flink_ml_tpu/serving/batcher.py``.

Concurrent small requests coalesce into a fixed set of padded batch shapes:

1. the first queued request is held at most ``max_delay_ms`` while more arrive;
2. whole requests are claimed FIFO up to ``max_batch_size`` rows;
3. the batch pads to the next **bucket** by repeating row 0 (row-wise
   transforms: pad rows influence nothing and are sliced off) — the powers
   of two up to ``max_batch_size``, or a sharded plan's mesh ladder
   (``PlanSharding.serving_buckets``: multiples of ``MIN_SHARD_ROWS · N``);
4. one execution serves the padded batch and per-request slices go back.

So a model version builds at most ``log2(max_batch_size)+1`` chains. The
``(rows, bucket)`` history records the true rows against the padded bucket.

Admission control: the queue is bounded in rows and a full queue rejects
synchronously with ``ServingOverloadedError``. Requests still queued past
their deadline fail with ``ServingDeadlineError``; a claimed request always
gets exactly one response.

Pipelined dispatch: with a ``dispatch`` callable (returning a handle whose
``result()`` is the blocking readback) the loop keeps up to
``pipeline_depth`` batches in flight — the GPU runs batch N while this
thread claims and pads batch N+1. Kernels launch from this thread on its
current CUDA stream; only ``result()`` waits for the device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.serving.errors import (
    ServingClosedError,
    ServingDeadlineError,
    ServingError,
    ServingExecutionError,
    ServingOverloadedError,
)

__all__ = ["power_of_two_buckets", "bucket_for", "pad_to", "PendingRequest", "MicroBatcher"]


def power_of_two_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """(1, 2, 4, ..., max_batch_size); ``max_batch_size`` is always a bucket."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    buckets: List[int] = []
    b = 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return tuple(buckets)


def bucket_for(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket holding ``rows`` (buckets ascending)."""
    for b in buckets:
        if rows <= b:
            return b
    raise ValueError(f"{rows} rows exceed the largest bucket {buckets[-1]}")


def pad_to(df: DataFrame, bucket: int) -> DataFrame:
    """Pad ``df`` to exactly ``bucket`` rows by repeating row 0."""
    n = len(df)
    if n == bucket:
        return df
    idx = np.concatenate([np.arange(n, dtype=np.int64), np.zeros(bucket - n, np.int64)])
    return df.take(idx)


# Request lifecycle (transitions under the batcher lock):
_PENDING = 0  # queued, waiting to be claimed
_CLAIMED = 1  # inside an executing batch — WILL complete
_TIMED_OUT = 2  # abandoned by its waiter; the loop discards it
_DONE = 3  # response or error delivered


class PendingRequest:
    """A submitted request: the client handle (``result()``) and the
    batcher-side state machine."""

    __slots__ = ("df", "rows", "enqueued_at", "deadline", "_event", "_state",
                 "response", "error", "_abandon_cb")

    def __init__(self, df: DataFrame, deadline: float):
        self.df = df
        self.rows = len(df)
        self.enqueued_at = time.perf_counter()
        self.deadline = deadline
        self._event = threading.Event()
        self._state = _PENDING
        self.response = None
        self.error: Optional[BaseException] = None

    def result(self):
        """Block until the response (or typed error) arrives. A request that
        times out while still queued raises ``ServingDeadlineError``; one
        already claimed rides its batch to completion."""
        remaining = self.deadline - time.perf_counter()
        if not self._event.wait(timeout=max(remaining, 0.0)) and self._abandon_cb():
            raise ServingDeadlineError(
                "request not served within its deadline",
                phase="queued",
                queued_ms=(time.perf_counter() - self.enqueued_at) * 1000.0,
            )
        self._event.wait()  # claimed concurrently with the deadline: it completes
        if self.error is not None:
            raise self.error
        return self.response


class MicroBatcher:
    """The coalescing loop. ``execute(padded_df) -> (out_df, version)`` serves
    a batch synchronously; ``dispatch(padded_df)`` returns a handle whose
    ``result()`` gives the same pair, or None to use ``execute``."""

    def __init__(
        self,
        execute: Callable[[DataFrame], Tuple[DataFrame, int]],
        *,
        max_batch_size: int,
        max_delay_ms: float,
        queue_capacity_rows: int,
        scope: str,
        response_factory: Callable[[DataFrame, int, float, int], object],
        dispatch: Optional[Callable[[DataFrame], Optional[object]]] = None,
        pipeline_depth: int = 1,
        buckets: Optional[Sequence[int]] = None,
    ):
        self._execute = execute
        self._dispatch = dispatch
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.queue_capacity_rows = int(queue_capacity_rows)
        # The server passes a sharded plan's mesh ladder, so every padded
        # batch splits evenly over its shards.
        self.buckets = (tuple(buckets) if buckets is not None
                        else power_of_two_buckets(self.max_batch_size))
        self.scope = scope
        self._response_factory = response_factory

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[PendingRequest] = []
        self._queued_rows = 0
        self._closed = False
        self._draining = False
        self.executed_batch_sizes: List[Tuple[int, int]] = []  # (rows, bucket) history
        self._thread = threading.Thread(target=self._loop, name=f"micro-batcher[{scope}]", daemon=True)
        self._thread.start()

    @property
    def draining(self) -> bool:
        """Whether a close is in progress or done (JAX ``batcher.py:246``)."""
        with self._lock:
            return self._draining

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    # -- client side ----------------------------------------------------------
    def submit(self, df: DataFrame, timeout_s: float) -> PendingRequest:
        rows = len(df)
        if rows == 0:
            raise ValueError("cannot serve an empty request")
        if rows > self.max_batch_size:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_size={self.max_batch_size}; "
                "split it or raise serving.max.batch.size"
            )
        req = PendingRequest(df, deadline=time.perf_counter() + timeout_s)
        with self._cond:
            if self._closed or self._draining:
                raise ServingClosedError("server is shut down; request rejected")
            if self._queued_rows + rows > self.queue_capacity_rows:
                metrics.counter(self.scope, MLMetrics.SERVING_REJECTED)
                raise ServingOverloadedError(self._queued_rows, self.queue_capacity_rows)
            self._install_abandon(req)
            self._queue.append(req)
            self._queued_rows += rows
            metrics.counter(self.scope, MLMetrics.SERVING_REQUESTS)
            metrics.gauge(self.scope, MLMetrics.SERVING_QUEUE_DEPTH, self._queued_rows)
            self._cond.notify_all()
        return req

    def _install_abandon(self, req: PendingRequest) -> None:
        def abandon() -> bool:
            with self._lock:
                if req._state == _PENDING:
                    req._state = _TIMED_OUT
                    metrics.counter(self.scope, MLMetrics.SERVING_TIMEOUTS)
                    return True
                return False  # claimed (or done): the batch owns it now

        req._abandon_cb = abandon

    # -- batching loop --------------------------------------------------------
    def _claim_batch(self, block: bool = True) -> Optional[List[PendingRequest]]:
        """Wait for work, coalesce up to max_batch_size rows, claim FIFO.
        Returns None only when closed and drained; with ``block=False``
        returns [] at once when the queue is empty."""
        with self._cond:
            while True:
                self._reap_locked()
                if self._queue:
                    break
                if self._closed:
                    return None
                if not block:
                    return []
                self._cond.wait(timeout=0.05)
            # Coalescing window: hold the head request up to max_delay while
            # more arrive. A closed (draining) batcher skips the wait.
            batch_deadline = self._queue[0].enqueued_at + self.max_delay_s
            while not self._closed:
                self._reap_locked()
                if self._queued_rows >= self.max_batch_size:
                    break
                remaining = batch_deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            claimed: List[PendingRequest] = []
            rows = 0
            while self._queue and rows + self._queue[0].rows <= self.max_batch_size:
                req = self._queue.pop(0)
                self._queued_rows -= req.rows
                req._state = _CLAIMED
                claimed.append(req)
                rows += req.rows
            metrics.gauge(self.scope, MLMetrics.SERVING_QUEUE_DEPTH, self._queued_rows)
            return claimed

    def _reap_locked(self) -> None:
        """Drop abandoned/expired requests still in the queue (lock held)."""
        now = time.perf_counter()
        kept = []
        for req in self._queue:
            if req._state == _TIMED_OUT:
                self._queued_rows -= req.rows
                continue
            if req.deadline <= now:
                req._state = _TIMED_OUT
                req.error = ServingDeadlineError(
                    "request expired in queue",
                    phase="queued",
                    queued_ms=(now - req.enqueued_at) * 1000.0,
                )
                self._queued_rows -= req.rows
                metrics.counter(self.scope, MLMetrics.SERVING_TIMEOUTS)
                req._event.set()
                continue
            kept.append(req)
        self._queue[:] = kept

    def _deliver_error(self, claimed: List[PendingRequest], e: BaseException) -> None:
        # Typed errors pass through; anything else is wrapped so clients never
        # see an untyped exception cross the thread rendezvous.
        if not isinstance(e, ServingError):
            e = ServingExecutionError(f"batch execution failed: {type(e).__name__}: {e}", cause=e)
        for req in claimed:
            req.error = e
            req._state = _DONE
            req._event.set()

    def _deliver(self, claimed: List[PendingRequest], out: DataFrame, version: int,
                 rows: int, bucket: int) -> None:
        """Scatter one executed batch's rows back to its waiters."""
        self.executed_batch_sizes.append((rows, bucket))
        metrics.observe(self.scope, MLMetrics.SERVING_BATCH_SIZE, rows)
        metrics.counter(self.scope, MLMetrics.SERVING_BATCHES)
        now = time.perf_counter()
        offset = 0
        for req in claimed:
            sliced = out.take(np.arange(offset, offset + req.rows, dtype=np.int64))
            offset += req.rows
            latency_ms = (now - req.enqueued_at) * 1000.0
            req.response = self._response_factory(sliced, version, latency_ms, bucket)
            metrics.observe(self.scope, MLMetrics.SERVING_LATENCY_MS, latency_ms)
            req._state = _DONE
            req._event.set()
        hist = metrics.histogram(self.scope, MLMetrics.SERVING_LATENCY_MS)
        p50, p99 = hist.quantiles((0.5, 0.99))
        metrics.gauge(self.scope, MLMetrics.SERVING_LATENCY_P50_MS, p50)
        metrics.gauge(self.scope, MLMetrics.SERVING_LATENCY_P99_MS, p99)

    def _run_batch(self, claimed: List[PendingRequest]) -> Optional[Tuple]:
        """Pad and launch one batch. Returns an in-flight record
        ``(claimed, rows, bucket, handle)`` when dispatched asynchronously,
        None when served (or failed) synchronously."""
        rows = sum(r.rows for r in claimed)
        bucket = bucket_for(rows, self.buckets)
        batch = claimed[0].df if len(claimed) == 1 else DataFrame.concat([r.df for r in claimed])
        padded = pad_to(batch, bucket)
        try:
            if self._dispatch is not None:
                handle = self._dispatch(padded)
                if handle is not None:
                    return (claimed, rows, bucket, handle)
            out, version = self._execute(padded)
        except Exception as e:  # noqa: BLE001 — delivered to each waiter
            self._deliver_error(claimed, e)
            return None
        self._deliver(claimed, out, version, rows, bucket)
        return None

    def _finalize_inflight(self, record: Tuple) -> None:
        claimed, rows, bucket, handle = record
        try:
            out, version = handle.result()  # the one blocking readback
        except Exception as e:  # noqa: BLE001 — delivered to each waiter
            self._deliver_error(claimed, e)
            return
        self._deliver(claimed, out, version, rows, bucket)

    def _loop(self) -> None:
        inflight: Deque[Tuple] = deque()
        while True:
            claimed = self._claim_batch(block=not inflight)
            if claimed is None:  # closed and queue drained
                while inflight:
                    self._finalize_inflight(inflight.popleft())
                return
            if claimed:
                record = self._run_batch(claimed)
                if record is not None:
                    inflight.append(record)
                # At most pipeline_depth batches outstanding; finalizing here
                # (after the next dispatch) overlaps batch N's device time with
                # batch N+1's host-side claim/pad/dispatch.
                while len(inflight) >= self.pipeline_depth:
                    self._finalize_inflight(inflight.popleft())
            elif inflight:  # queue idle: harvest the oldest in-flight batch
                self._finalize_inflight(inflight.popleft())
            metrics.gauge(self.scope, MLMetrics.SERVING_INFLIGHT_DEPTH, len(inflight))

    # -- shutdown -------------------------------------------------------------
    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop accepting requests; with ``drain`` the loop finishes
        everything already queued, otherwise queued requests fail with
        ``ServingClosedError``."""
        with self._cond:
            if self._closed:
                return
            self._draining = True
            if not drain:
                for req in self._queue:
                    if req._state == _PENDING:
                        req._state = _DONE
                        req.error = ServingClosedError("server shut down before execution")
                        req._event.set()
                self._queue.clear()
                self._queued_rows = 0
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout_s)
