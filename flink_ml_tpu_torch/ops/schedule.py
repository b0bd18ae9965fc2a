"""Host-side epoch/minibatch schedules for the fused trainers — twin of
``flink_ml_tpu/ops/schedule.py``.

Pure numpy: the schedule is a function of the epoch index alone, so the
trainer computes it on the host and never reads a slice start back from the
device.
"""
from __future__ import annotations

import numpy as np

__all__ = ["offset_schedule", "chunked_schedule"]


def offset_schedule(m: int, local_batch: int, n_epochs: int):
    """Per-epoch (start, offset) slice schedule for a cache of ``m`` rows:
    the reference's nextBatchOffset cycling (SGD.java:265-268), with the
    slice start clamped to ``m - local_batch`` at the tail."""
    starts = np.empty(n_epochs, np.int32)
    offsets = np.empty(n_epochs, np.int32)
    off = 0
    for e in range(n_epochs):
        offsets[e] = off
        starts[e] = min(off, m - local_batch)
        off = 0 if off + local_batch >= m else off + local_batch
    return starts, offsets


def chunked_schedule(starts: np.ndarray, offsets: np.ndarray, max_iter: int, chunk: int):
    """Yield per-chunk (starts, offsets, active, n_active) views of an epoch
    schedule, padding the last chunk to the fixed chunk width with inactive
    epochs."""
    for c0 in range(0, max_iter, chunk):
        pad = max(0, c0 + chunk - max_iter)
        sl = slice(c0, c0 + chunk - pad)
        yield (
            np.concatenate([starts[sl], np.zeros(pad, np.int32)]),
            np.concatenate([offsets[sl], np.zeros(pad, np.int32)]),
            np.concatenate([np.ones(chunk - pad, bool), np.zeros(pad, bool)]),
            chunk - pad,
        )
