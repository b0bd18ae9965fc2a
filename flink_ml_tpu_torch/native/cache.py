"""NativeDataCache — the ``HostDataCache`` contract over the C++ chunk store;
twin of ``flink_ml_tpu/native/cache.py``.

Columnar chunks are appended, read back at random and in order, and
snapshotted, as in ``iteration/datacache.py``'s ``HostDataCache``; the
payload bytes live in the native store (resident up to the budget, spilled
to files past it). Snapshots use the same ``MANIFEST.json`` + ``chunk{i}.npz``
format as the Python tier and as both JAX tiers, so every cache recovers any
other's snapshot. This is host storage, not a device path.

Chunk encoding: an 8-byte little-endian header length, a JSON header
``{name: [dtype, shape]}``, then each column's raw buffer in header order.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, Optional

import numpy as np

from flink_ml_tpu_torch.native.chunk_store import NativeChunkStore

__all__ = ["NativeDataCache"]


def _pack(chunk: Dict[str, np.ndarray]) -> bytes:
    header = {}
    buffers = []
    for name, arr in chunk.items():
        arr = np.ascontiguousarray(arr)
        header[name] = [arr.dtype.str, list(arr.shape)]
        buffers.append(arr.tobytes())
    header_bytes = json.dumps(header).encode()
    return struct.pack("<Q", len(header_bytes)) + header_bytes + b"".join(buffers)


def _unpack(data: bytes) -> Dict[str, np.ndarray]:
    (header_len,) = struct.unpack_from("<Q", data, 0)
    header = json.loads(data[8:8 + header_len].decode())
    out = {}
    offset = 8 + header_len
    for name, (dtype_str, shape) in header.items():
        dtype = np.dtype(dtype_str)
        count = int(np.prod(shape))
        out[name] = np.frombuffer(data, dtype, count=count, offset=offset).reshape(shape)
        offset += dtype.itemsize * count
    return out


class NativeDataCache:
    """Drop-in for ``HostDataCache`` backed by the native chunk store;
    arguments left None take ``datacache.memory.budget.bytes`` and
    ``datacache.spill.dir``."""

    def __init__(self, memory_budget_bytes: Optional[int] = None, spill_dir: Optional[str] = None):
        from flink_ml_tpu_torch.config import resolve_cache_config

        memory_budget_bytes, spill_dir = resolve_cache_config(memory_budget_bytes, spill_dir)
        self._store = NativeChunkStore(memory_budget_bytes, spill_dir)
        self._chunk_rows: list = []
        self._n_rows = 0
        self._finished = False

    # --- write side ----------------------------------------------------------
    def append(self, chunk: Dict[str, np.ndarray]) -> None:
        if self._finished:
            raise RuntimeError("cache already finished")
        chunk = {k: np.asarray(v) for k, v in chunk.items()}
        lengths = {v.shape[0] for v in chunk.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        self._store.append(_pack(chunk))
        self._chunk_rows.append(n)
        self._n_rows += n

    def finish(self) -> None:
        self._finished = True

    @property
    def num_rows(self) -> int:
        return self._n_rows

    @property
    def memory_bytes(self) -> int:
        return self._store.memory_bytes

    @property
    def spilled_chunks(self) -> int:
        return self._store.spilled_chunks

    # --- read side -----------------------------------------------------------
    def _chunk_at(self, idx: int) -> Dict[str, np.ndarray]:
        return _unpack(self._store.read(idx))

    def _chunks(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self._store)):
            yield self._chunk_at(i)

    def iter_rows(self) -> Iterator[Dict[str, np.ndarray]]:
        yield from self._chunks()

    def rows(self, start: int, stop: int) -> Dict[str, np.ndarray]:
        """Rows ``[start, stop)``, copied out (see ``HostDataCache.rows``)."""
        from flink_ml_tpu_torch.iteration.datacache import _gather_rows

        return _gather_rows(self._chunk_rows, self._chunk_at, start, stop)

    def iter_minibatches(self, batch_size: int, drop_last: bool = False):
        from flink_ml_tpu_torch.iteration.stream import rebatch

        yield from rebatch(self._chunks(), batch_size, drop_last=drop_last)

    # --- snapshot (the HostDataCache format) ---------------------------------
    def snapshot(self, path: str) -> None:
        from flink_ml_tpu_torch.iteration.datacache import write_snapshot

        write_snapshot(self._chunks(), self._n_rows, path)

    @classmethod
    def recover(cls, path: str, **kwargs) -> "NativeDataCache":
        from flink_ml_tpu_torch.iteration.datacache import recover_chunks

        return recover_chunks(cls(**kwargs), path)

    def close(self) -> None:
        self._store.close()
