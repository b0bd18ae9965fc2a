"""The C++ spillable chunk store behind ``NativeDataCache``, bound with ctypes
— twin of ``flink_ml_tpu/native/__init__.py``'s ``NativeChunkStore``.

``datacache.cpp`` beside this module is the JAX package's source, copied: an
append-only log of byte chunks held in memory up to a budget, whole chunks
past it written to files under a spill directory, read back at random. It is
host storage, not a device path, so the host C++ compiler builds it:

    g++ -O2 -shared -fPIC -std=c++17 datacache.cpp -o <build>/datacache-<hash>.so

at first use, into ``BUILD_DIR`` under a name carrying the hash of the
source and the flags. The compiler writes a name of its own (process and
thread in it) and ``os.replace`` moves the whole library into place, so two
processes building at once never load a half-written file. Nothing builds
at import: ``native_available()`` says whether the store can be used, and
``create_capacity_cache`` falls back to the pure-Python ``HostDataCache``
when it cannot.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ["NativeChunkStore", "load_datacache_lib", "native_available"]

SOURCE = Path(__file__).resolve().parent / "datacache.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    from flink_ml_tpu_torch.native import BUILD_DIR

    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"datacache-{digest}.so"


def _build(lib: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}): {proc.stderr[-1000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole library or none


def load_datacache_lib() -> ctypes.CDLL:
    """Build (once, unless already built) and load the chunk store; a failed
    build is remembered and raised again without a retry."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            lib_path = library_path()
            if not lib_path.is_file():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except Exception as e:  # noqa: BLE001 — any failure leaves the store unavailable
            _build_error = f"{type(e).__name__}: {e}"
            raise RuntimeError(_build_error) from e
        lib.dc_create.restype = ctypes.c_void_p
        lib.dc_create.argtypes = [ctypes.c_size_t, ctypes.c_char_p]
        lib.dc_append.restype = ctypes.c_long
        lib.dc_append.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.dc_num_chunks.restype = ctypes.c_long
        lib.dc_num_chunks.argtypes = [ctypes.c_void_p]
        lib.dc_chunk_size.restype = ctypes.c_long
        lib.dc_chunk_size.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.dc_read.restype = ctypes.c_int
        lib.dc_read.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
        lib.dc_memory_bytes.restype = ctypes.c_size_t
        lib.dc_memory_bytes.argtypes = [ctypes.c_void_p]
        lib.dc_spilled_chunks.restype = ctypes.c_long
        lib.dc_spilled_chunks.argtypes = [ctypes.c_void_p]
        lib.dc_destroy.restype = None
        lib.dc_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the chunk store builds and loads here."""
    try:
        load_datacache_lib()
        return True
    except RuntimeError:
        return False


class NativeChunkStore:
    """One C chunk store: appended byte chunks, resident up to
    ``memory_budget_bytes`` and spilled past it to a directory of its own
    under ``spill_dir`` (the C store names its files by chunk index only, so
    two stores on one spill directory would overwrite each other's); freed,
    with that directory, by ``close`` or when collected."""

    def __init__(self, memory_budget_bytes: int, spill_dir: Optional[str] = None):
        self._lib = load_datacache_lib()
        self._spill_path = None
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            self._spill_path = tempfile.mkdtemp(prefix="chunkstore-", dir=spill_dir)
        self._handle = self._lib.dc_create(memory_budget_bytes,
                                           self._spill_path.encode() if self._spill_path else None)
        if not self._handle:
            raise MemoryError("dc_create failed")

    def append(self, data: bytes) -> int:
        idx = self._lib.dc_append(self._handle, data, len(data))
        if idx < 0:
            raise IOError("dc_append failed (spill write error?)")
        return idx

    def __len__(self) -> int:
        return self._lib.dc_num_chunks(self._handle)

    def read(self, idx: int) -> bytearray:
        """Chunk ``idx``'s bytes, copied once out of the store."""
        size = self._lib.dc_chunk_size(self._handle, idx)
        if size < 0:
            raise IndexError(f"chunk {idx} out of range")
        buf = bytearray(size)
        if self._lib.dc_read(self._handle, idx, (ctypes.c_char * size).from_buffer(buf)) != 0:
            raise IOError(f"dc_read failed for chunk {idx}")
        return buf

    @property
    def memory_bytes(self) -> int:
        return self._lib.dc_memory_bytes(self._handle)

    @property
    def spilled_chunks(self) -> int:
        return self._lib.dc_spilled_chunks(self._handle)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.dc_destroy(self._handle)
            self._handle = None
        if getattr(self, "_spill_path", None):
            shutil.rmtree(self._spill_path, ignore_errors=True)
            self._spill_path = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
