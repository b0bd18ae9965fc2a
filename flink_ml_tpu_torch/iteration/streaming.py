"""Streamed training windows over host-tier caches — twin of
``flink_ml_tpu/iteration/streaming.py``.

Reference: ``ListStateWithCache.java:43`` — each SGD/KMeans subtask caches
its training partition in managed memory spilling to disk
(``DataCacheWriter.java:37``) and re-reads it every epoch.

Here the capacity tier (``HostDataCache`` / ``NativeDataCache``) holds the
dataset on the host (RAM + spill files) and training streams fixed-size
per-shard *windows* onto the device: every minibatch epoch that falls inside
the resident window runs as one chunk of launches (``run``), and the next
window is read, pinned and copied while the device computes the current
run. The overlap needs three things, which this module and the trainers
keep:

- ``dispatch`` only queues a run's kernels (no ``.cpu()`` or ``.item()``);
  the one place that may wait is the ``observe`` callable it returns, which
  ``run_windows`` calls after the next window's load was issued;
- a window's host arrays are fresh copies (``cache.rows`` never returns a
  view into a spill file), pinned, and copied with ``non_blocking=True`` on
  a copy stream; the compute stream waits on the copy's event before the
  first run reads the window (``land``);
- a window's tensors are marked with ``record_stream`` for the compute
  stream when they land, so memory the caching allocator gets back when
  ``run_windows`` drops a window is not reused while a queued kernel still
  reads it.

Window layout, as in the JAX package: with ``m = ceil(n / n_data)`` rows per
data shard, shard ``k``'s window ``j`` holds rows ``[k·m + j·W, k·m +
min((j+1)·W, m))`` of the cache, zero-padded to ``W`` rows with a zero mask.
A rank loads only its own data shard's rows. Streamed training thus follows
the resident cache's per-shard batch-offset cycling (SGD.java:246-285): when
the local batch divides the shard, every epoch reads the resident path's
rows and weights; at a ragged tail the short batch is the window's masked
padding instead of the resident path's clamped re-read (the same weighted
sums in another order).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["WindowSchedule", "WindowedStream", "is_host_cache", "land", "plan_windows", "run_windows"]


def is_host_cache(obj) -> bool:
    """The capacity-tier cache contract (``HostDataCache``,
    ``NativeDataCache`` or anything with ``num_rows`` and ``rows(start,
    stop)``)."""
    return hasattr(obj, "num_rows") and hasattr(obj, "rows")


class WindowSchedule:
    """Epoch → window assignment for per-shard batch-offset cycling.

    ``runs`` is a list of ``(window_idx, local_starts)``, ``local_starts``
    the slice starts relative to the window; consecutive epochs in the same
    window form one run of at most ``chunk_len`` epochs — the lesser of
    ``window // batch`` and ``fused_chunk_len``'s dispatch length."""

    def __init__(self, local_rows: int, local_batch: int, window_rows: int, max_iter: int,
                 serial_elems_per_epoch: int = 0, check_loss: bool = False,
                 flops_per_epoch: float = 0.0):
        # offset_schedule is the resident path's own cycling rule
        from flink_ml_tpu_torch.ops.optimizer import fused_chunk_len
        from flink_ml_tpu_torch.ops.schedule import offset_schedule

        b = local_batch
        W = max(b, min(int(window_rows), local_rows))
        W = -(-W // b) * b  # a whole number of batches
        self.window = W
        self.n_windows = -(-local_rows // W)
        # capped by max_iter too: a short fit over a large window does not
        # pad its run to a mostly inactive full width
        self.chunk_len = min(
            max(1, W // b),
            fused_chunk_len(max_iter, check_loss, serial_elems_per_epoch, flops_per_epoch),
        )
        _, offsets = offset_schedule(local_rows, b, max_iter)
        runs: List[Tuple[int, List[int]]] = []
        for off in offsets:
            j = int(off) // W
            if runs and runs[-1][0] == j and len(runs[-1][1]) < self.chunk_len:
                runs[-1][1].append(int(off) - j * W)
            else:
                runs.append((j, [int(off) - j * W]))
        self.runs = [(j, np.asarray(starts, np.int32)) for j, starts in runs]

    def padded(self, starts: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """``(starts, active, n_active)`` padded to ``chunk_len``, the
        padding contract of every chunked trainer."""
        from flink_ml_tpu_torch.ops.schedule import chunked_schedule

        starts_c, _, active, n_active = next(chunked_schedule(starts, starts, len(starts), self.chunk_len))
        return starts_c, active, n_active


def _flat_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _flat_tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _flat_tensors(x)


class _Uploader:
    """Host arrays onto ``device``: on the CPU as they are (they are fresh
    copies); on CUDA pinned and copied with ``non_blocking=True`` on a copy
    stream of the uploader's own, followed by ``after`` (work that builds
    device tensors from the uploaded ones, queued on the copy stream too) and
    an event the compute stream waits on (``land``)."""

    def __init__(self, device: torch.device):
        self.device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, host: Dict[str, np.ndarray], after=None) -> dict:
        if self._stream is None:
            out = {k: torch.from_numpy(v) for k, v in host.items()}
            if after is not None:
                out.update(after(out))
            return out
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            if after is not None:
                out.update(after(out))
            uploaded = torch.cuda.Event()
            uploaded.record(self._stream)
        out["__uploaded__"] = uploaded
        return out


def land(window: dict) -> dict:
    """Make ``window``'s tensors safe to read on the current stream: wait on
    its upload event and ``record_stream`` every tensor (they were made on
    the copy stream). Idempotent: the event is consumed the first time."""
    uploaded = window.pop("__uploaded__", None)
    if uploaded is not None:
        compute = torch.cuda.current_stream(next(_flat_tensors(window)).device)
        compute.wait_event(uploaded)
        for t in _flat_tensors(window):
            t.record_stream(compute)
    return window


def _shard(ctx) -> Tuple[int, int]:
    """``(n_data, data_index)`` of ``ctx``, ``(1, 0)`` for one device."""
    return (1, 0) if ctx is None else (ctx.n_data, ctx.data_index)


class WindowedStream:
    """Loads this rank's windows of a host-tier cache onto its device.

    ``columns`` maps output name → cache column name; a loaded window is a
    dict of tensors ``[W, ...]`` plus ``"__mask__"`` (1.0 on real rows, 0.0
    on window and shard padding). A column named in ``optional`` may be
    absent from the cache and fills with ones (the weights default); any
    other missing column raises at construction. ``dtypes`` overrides the
    default dtype per output column (int32 for padded-CSR ``indices``).
    ``window`` must be the batch-aligned width of the matching
    ``WindowSchedule``: make both with ``plan_windows``.

    A subclass adds to a window through two hooks: ``host_extra(rows)``
    returns more host arrays built from the window's cache rows (``rows`` is
    None for a window past the shard's end), and ``on_device(window)``, if
    set, builds device tensors from the uploaded ones as the window lands."""

    on_device = None

    def __init__(self, cache, columns: Dict[str, str], ctx, window: int, dtype=np.float32,
                 transforms: Optional[Dict[str, object]] = None,
                 dtypes: Optional[Dict[str, object]] = None,
                 optional: Sequence[str] = ("weights", "w"), device=None):
        from flink_ml_tpu_torch.device import resolve_device

        self.cache = cache
        self.columns = columns
        self.ctx = ctx
        self.dtype = np.dtype(dtype)
        self.dtypes = {k: np.dtype(v) for k, v in (dtypes or {}).items()}
        self.transforms = transforms or {}
        self.optional = set(optional)
        self.n = int(cache.num_rows)
        if self.n == 0:
            raise ValueError("cannot stream an empty cache")
        n_data, _ = _shard(ctx)
        self.m = -(-self.n // n_data)
        self.window = int(window)
        peek = cache.rows(0, 1)
        missing = [col for out, col in columns.items() if col not in peek and out not in self.optional]
        if missing:
            raise KeyError(f"cache columns {missing} not found (cache has {sorted(peek)})")
        self._present = {out: col in peek for out, col in columns.items()}
        self._shapes = {out: peek[col].shape[1:] if col in peek else () for out, col in columns.items()}
        self._upload = _Uploader(ctx.device if ctx is not None else resolve_device(device))
        self.parts: List[Dict[str, float]] = []  # each load's host seconds: rows read, filled, uploaded

    def load(self, j: int) -> dict:
        """Window ``j`` of this rank's data shard, on its device; appends the
        host seconds of its three parts to ``parts``: the cache's ``rows``,
        the host fill (columns and ``host_extra``) and the upload call
        (pinning and queueing the copies and ``on_device``)."""
        W, m, n = self.window, self.m, self.n
        _, k = _shard(self.ctx)
        host = {out: np.zeros((W,) + self._shapes[out], self.dtypes.get(out, self.dtype))
                for out in self.columns}
        mask = np.zeros(W, self.dtype)
        lo = k * m + j * W
        hi = min(k * m + min((j + 1) * W, m), n)
        t0 = time.perf_counter()
        got = self.cache.rows(lo, hi) if hi > lo else None
        t1 = time.perf_counter()
        if got is not None:
            for out, col in self.columns.items():
                if self._present[out]:
                    val = got[col]
                    tf = self.transforms.get(out)
                    if tf is not None:
                        val = tf(np.asarray(val))
                    host[out][:hi - lo] = np.asarray(val, self.dtypes.get(out, self.dtype))
                else:
                    host[out][:hi - lo] = 1.0
            mask[:hi - lo] = 1.0
        host["__mask__"] = mask
        host.update(self.host_extra(got))
        t2 = time.perf_counter()
        out = self._upload(host, after=self.on_device)
        self.parts.append({"rows_s": t1 - t0, "fill_s": t2 - t1, "upload_s": time.perf_counter() - t2})
        return out

    def host_extra(self, rows: Optional[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return {}


def plan_windows(cache, columns: Dict[str, str], ctx, window_rows: int, local_batch: int,
                 max_iter: int, dtype=np.float32, transforms: Optional[Dict[str, object]] = None,
                 dtypes: Optional[Dict[str, object]] = None, serial_elems_per_epoch: int = 0,
                 check_loss: bool = False, flops_per_epoch: float = 0.0,
                 device=None) -> Tuple[WindowedStream, WindowSchedule]:
    """A ``(stream, schedule)`` pair of one batch-aligned window width."""
    n = int(cache.num_rows)
    if n == 0:
        raise ValueError("cannot stream an empty cache")
    m = -(-n // _shard(ctx)[0])
    sched = WindowSchedule(m, local_batch, window_rows, max_iter, serial_elems_per_epoch, check_loss,
                           flops_per_epoch)
    stream = WindowedStream(cache, columns, ctx, sched.window, dtype, transforms, dtypes, device=device)
    return stream, sched


def run_windows(stream, sched: WindowSchedule, dispatch, start_run: int = 0) -> List[float]:
    """Drive the window runs with one-ahead prefetch and lazy eviction;
    returns the host seconds of each window load.

    ``dispatch(run_index, window, starts, active, n_active)`` queues the
    run's device work and may return an ``observe`` callable; it is
    called after the next window's load was issued, so that load overlaps
    the run, and stops when it returns True (the streamed form of the host
    loop's criteria check). A window the next run revisits stays resident;
    the others are dropped as soon as the runs leave them, so at most two
    windows are on the device."""
    runs = sched.runs
    load_s: List[float] = []

    def load(j):
        t0 = time.perf_counter()
        window = stream.load(j)
        load_s.append(time.perf_counter() - t0)
        return window

    if start_run >= len(runs):
        return load_s
    bufs = {runs[start_run][0]: load(runs[start_run][0])}
    for i in range(start_run, len(runs)):
        j, starts_local = runs[i]
        starts_c, active_c, n_active = sched.padded(starts_local)
        observe = dispatch(i, land(bufs[j]), starts_c, active_c, n_active)
        next_j = runs[i + 1][0] if i + 1 < len(runs) else None
        if next_j is not None and next_j not in bufs:
            bufs[next_j] = load(next_j)  # overlaps the run just queued
        if next_j != j:
            bufs.pop(j, None)
        if observe is not None and observe():
            break
    return load_s
