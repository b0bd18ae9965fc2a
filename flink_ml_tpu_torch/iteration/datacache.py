"""The training-data cache — twin of ``flink_ml_tpu/iteration/datacache.py``'s
``DeviceDataCache``.

The dataset is placed on the device **once** and every epoch reads the same
buffers: zero host↔device traffic after load. Without a mesh the cache holds
every row on one device (``local_rows == n_valid``). On a
:class:`~flink_ml_tpu_torch.parallel.mesh.MeshContext` of N ranks, as the JAX
cache shards over its mesh's data axis, every rank is handed the whole input
and uploads only its contiguous share: the rows are zero-padded to a multiple
of N, rank k holds ``[k·m, (k+1)·m)`` with ``m = ceil(n / N)``, and the mask
is 0 on the padding; the ranks of one data index (the model shards of a
tensor-parallel mesh) hold the same rows. A column named in
``column_specs`` with the model axis on its second dimension (JAX
``P(data, model)``) is column-sliced as well: its width zero-padded to a
multiple of ``n_model`` and the rank's slice uploaded, so dense tensor
parallelism never holds the whole matrix on a rank.

``HostDataCache`` is the capacity tier (JAX :163-290) for datasets larger
than the card: appended columnar chunks in host RAM up to a memory budget,
the chunks past it written as ``.npy`` files in a directory of the cache's
own under the spill directory (so caches that share one spill directory,
as the ranks of one host do, never read each other's files) and read back
memory-mapped; ``close`` removes them. ``rows(start, stop)`` reads any row range, copied
out of the chunk log (``_gather_rows``), so a caller never holds a view
into a spill file; the streamed trainers (``iteration/streaming.py``) pin
and upload such copies a window at a time. ``snapshot``/``recover`` use the
JAX package's on-disk format (``MANIFEST.json`` + ``chunk{i}.npz``), so
either package recovers the other's snapshot. ``create_capacity_cache``
returns the C++-backed ``NativeDataCache`` (``native/cache.py``) when
``native.datacache.enabled`` is set and the chunk store builds, else a
``HostDataCache``: the same contract.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from flink_ml_tpu_torch.device import resolve_device

__all__ = ["DeviceDataCache", "HostDataCache", "create_capacity_cache"]


def _model_axis_spec(spec) -> bool:
    """Whether a JAX-style spec tuple names the model axis on dimension 1."""
    return spec is not None and len(spec) > 1 and spec[1] == "model"


class DeviceDataCache:
    """Columnar dataset resident on ``device`` (``None`` → the GPU), or this
    rank's share of it on ``ctx``'s device.

    ``columns`` maps name → host array [n, ...] (every rank passes the whole
    input). The sparse columns (``indices``/``values``) are also kept on the
    host whole, zero-copy, because the one-hot layout is built from them
    there over every rank's rows. ``mask`` is 1.0 on real rows and 0.0 on
    the mesh's padding. The trainer memoises its one-hot layout
    (``_onehot_memo``) and materialised row one-hots (``_onehot_premat_memo``)
    on the cache, so they live as long as the data.
    """

    def __init__(self, columns: Dict[str, np.ndarray],
                 device: Optional[Union[str, torch.device]] = None, ctx=None,
                 column_specs: Optional[Dict[str, tuple]] = None):
        self.ctx = ctx
        self.device = ctx.device if ctx is not None else resolve_device(device)
        lengths = {np.asarray(c).shape[0] for c in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        n_data = ctx.n_data if ctx is not None else 1
        lo, hi, m = ctx.local_range(n) if ctx is not None else (0, n, n)
        self.n_valid = n
        self.n_padded = m * n_data
        self.host_columns: Dict[str, np.ndarray] = {}
        self.arrays: Dict[str, torch.Tensor] = {}
        self.model_sharded = set()
        for name, col in columns.items():
            col = np.asarray(col)
            if name in ("indices", "values"):
                self.host_columns[name] = col
            local = col[lo:hi]
            if _model_axis_spec((column_specs or {}).get(name)) and ctx is not None:
                c0, c1, d_pad = ctx.model_range(col.shape[1])
                if d_pad > col.shape[1]:  # zero columns: zero margins, zero gradients
                    local = np.concatenate([local, np.zeros((local.shape[0], d_pad - col.shape[1]), col.dtype)], 1)
                local = local[:, c0:c1]
                self.model_sharded.add(name)
            if hi - lo < m:  # the rank holding the padding
                local = np.concatenate([local, np.zeros((m - (hi - lo),) + col.shape[1:], col.dtype)])
            self.arrays[name] = torch.from_numpy(np.ascontiguousarray(local)).to(self.device)
        mask = torch.zeros(m, dtype=torch.float32)
        mask[: hi - lo] = 1.0
        self.arrays["__mask__"] = mask.to(self.device)
        self._onehot_memo = None
        self._onehot_premat_memo = None

    @property
    def n_data(self) -> int:
        return self.ctx.n_data if self.ctx is not None else 1

    @property
    def local_rows(self) -> int:
        """Rows on this device (padded on a mesh)."""
        return self.n_padded // self.n_data

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    @property
    def mask(self) -> torch.Tensor:
        return self.arrays["__mask__"]


def create_capacity_cache(memory_budget_bytes=None, spill_dir=None):
    """A capacity-tier cache under the config tier: the C++-backed
    ``NativeDataCache`` when ``native.datacache.enabled`` is set and the
    chunk store builds, else ``HostDataCache`` (the same contract; their
    snapshots are interchangeable on disk)."""
    from flink_ml_tpu_torch.config import Options, config

    if config.get(Options.NATIVE_DATACACHE_ENABLED):
        from flink_ml_tpu_torch.native import native_available

        if native_available():
            from flink_ml_tpu_torch.native.cache import NativeDataCache

            return NativeDataCache(memory_budget_bytes, spill_dir)
    return HostDataCache(memory_budget_bytes, spill_dir)


def _gather_rows(chunk_rows, chunk_at, start: int, stop: int) -> Dict[str, np.ndarray]:
    """Rows ``[start, stop)`` of an append-ordered chunk log, as fresh
    arrays (never a view into a chunk or a memory-mapped spill file).
    ``chunk_at(i)`` materialises or memory-maps chunk ``i``'s columns; both
    cache tiers share this."""
    total = sum(chunk_rows)
    if not 0 <= start <= stop <= total:
        raise IndexError(f"rows [{start}, {stop}) out of range [0, {total})")
    parts: List[Dict[str, np.ndarray]] = []
    pos = 0
    for i, n in enumerate(chunk_rows):
        if pos >= stop:
            break
        end = pos + n
        if end > start:
            a, b = max(start - pos, 0), min(stop - pos, n)
            parts.append({k: np.asarray(v[a:b]) for k, v in chunk_at(i).items()})
        pos = end
    if not parts:  # an empty range: zero-row arrays of the right dtypes and shapes
        if not chunk_rows:
            return {}
        return {k: np.array(v[:0]) for k, v in chunk_at(0).items()}
    if len(parts) == 1:
        return {k: np.array(v) for k, v in parts[0].items()}
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


class HostDataCache:
    """Append-only columnar cache in host RAM with disk spill.

    ``append`` adds a chunk (a dict of equally long arrays); once
    ``memory_budget_bytes`` would be exceeded, later chunks are written as
    ``.npy`` files in a directory of this cache's own under ``spill_dir``
    and memory-mapped on read (without a spill directory they stay in RAM);
    ``close``, or collection, removes that directory. ``iter_minibatches`` yields
    ``batch_size``-row batches of one pass (a trailing partial batch unless
    ``drop_last``), as the reference's DataCacheReader replays its cache.
    Arguments left None take ``datacache.memory.budget.bytes`` and
    ``datacache.spill.dir``."""

    def __init__(self, memory_budget_bytes: Optional[int] = None, spill_dir: Optional[str] = None):
        from flink_ml_tpu_torch.config import resolve_cache_config

        self.memory_budget, self.spill_dir = resolve_cache_config(memory_budget_bytes, spill_dir)
        # append-ordered log; each entry is {"mem": chunk} or {"files": paths}
        self._log: List[Dict[str, object]] = []
        self._chunk_rows: List[int] = []
        self._mem_bytes = 0
        self._n_rows = 0
        self._spill_count = 0
        self._spill_path: Optional[str] = None  # this cache's own directory, made at the first spill
        self._finished = False

    # --- write side (DataCacheWriter.addRecord/finish) -----------------------
    def append(self, chunk: Dict[str, np.ndarray]) -> None:
        if self._finished:
            raise RuntimeError("cache already finished")
        chunk = {k: np.asarray(v) for k, v in chunk.items()}
        lengths = {v.shape[0] for v in chunk.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        nbytes = sum(v.nbytes for v in chunk.values())
        if self._mem_bytes + nbytes > self.memory_budget and self.spill_dir:
            if self._spill_path is None:
                os.makedirs(self.spill_dir, exist_ok=True)
                self._spill_path = tempfile.mkdtemp(prefix="datacache-", dir=self.spill_dir)
            files = {}
            for k, v in chunk.items():
                path = os.path.join(self._spill_path, f"chunk{self._spill_count}_{k}.npy")
                np.save(path, v)
                files[k] = path
            self._log.append({"files": files})
            self._spill_count += 1
        else:
            self._log.append({"mem": chunk})
            self._mem_bytes += nbytes
        self._chunk_rows.append(n)
        self._n_rows += n

    def finish(self) -> None:
        self._finished = True

    @property
    def num_rows(self) -> int:
        return self._n_rows

    # --- read side (DataCacheReader) -----------------------------------------
    def _chunk_at(self, idx: int) -> Dict[str, np.ndarray]:
        entry = self._log[idx]
        if "mem" in entry:
            return entry["mem"]  # type: ignore[return-value]
        return {k: np.load(path, mmap_mode="r") for k, path in entry["files"].items()}  # type: ignore[union-attr]

    def _chunks(self) -> Iterator[Dict[str, np.ndarray]]:
        """Chunks in append order (RAM and spilled chunks as written)."""
        for i in range(len(self._log)):
            yield self._chunk_at(i)

    def iter_rows(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self._chunks()

    def rows(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        """Rows ``[start, stop)`` across the chunk log, copied out (a spilled
        chunk is memory-mapped and only the requested rows are read).
        Requires ``0 <= start <= stop <= num_rows``."""
        return _gather_rows(self._chunk_rows, self._chunk_at, start, stop)

    def iter_minibatches(self, batch_size: int, drop_last: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """One pass in ``batch_size``-row batches, re-chunked across chunk
        boundaries."""
        from flink_ml_tpu_torch.iteration.stream import rebatch

        yield from rebatch(({k: np.asarray(v) for k, v in c.items()} for c in self._chunks()),
                           batch_size, drop_last=drop_last)

    # --- snapshot (DataCacheSnapshot.writeTo/recover) ------------------------
    def snapshot(self, path: str) -> None:
        write_snapshot(self._chunks(), self._n_rows, path)

    @classmethod
    def recover(cls, path: str, **kwargs) -> "HostDataCache":
        return recover_chunks(cls(**kwargs), path)

    def close(self) -> None:
        """Remove this cache's spill files (a view ``iter_rows`` handed out
        stays readable: the mapping outlives the unlinked file)."""
        if self._spill_path is not None:
            shutil.rmtree(self._spill_path, ignore_errors=True)
            self._spill_path = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


def write_snapshot(chunks, num_rows: int, path: str) -> None:
    """``chunk{i}.npz`` per chunk, then ``MANIFEST.json``, which guards
    against stale chunk files of an earlier, larger snapshot in the same
    directory (the JAX package's format)."""
    os.makedirs(path, exist_ok=True)
    count = 0
    for i, chunk in enumerate(chunks):
        np.savez(os.path.join(path, f"chunk{i}.npz"), **chunk)
        count = i + 1
    with open(os.path.join(path, "MANIFEST.json"), "w") as f:
        json.dump({"num_chunks": count, "num_rows": num_rows}, f)


def recover_chunks(cache, path: str):
    """Append a snapshot directory's chunks to ``cache``, finish and return it."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for i in range(manifest["num_chunks"]):
        with np.load(os.path.join(path, f"chunk{i}.npz")) as z:
            cache.append({k: z[k] for k in z.files})
    cache.finish()
    return cache
