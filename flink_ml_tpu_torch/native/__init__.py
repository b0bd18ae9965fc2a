"""Hand-written CUDA kernels: built with nvcc at first use, bound with ctypes.

Each kernel's source lives in ``flink_ml_tpu_torch/csrc/`` and compiles on
its own into a shared library with a plain C interface (no PyTorch headers,
so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <source>.cu

The library lands in :data:`BUILD_DIR` under a name carrying the hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is loaded as is. Every C entry point takes ``c_void_p`` pointers and stream and
returns ``cudaGetLastError()`` after its launch; :meth:`CudaKernel.launch`
raises on a nonzero code and counts the launch.

Nothing here runs at import: the build and the ``ctypes`` load happen inside
the first launch, so machines without nvcc or a card import the package.

The host-side C++ chunk store of the capacity-tier cache
(``native/datacache.cpp``, built with g++ into the same directory) is bound
in ``native/chunk_store.py``; its three names are re-exported here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Sequence

__all__ = [
    "BUILD_DIR", "CSRC_DIR", "KERNELS", "BuildResult", "CudaKernel", "NativeChunkStore", "build",
    "check_tensor", "load_datacache_lib", "native_available",
]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
#: Built libraries (listed in .gitignore).
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register / shared-memory / spill report, kept in the build log
)

#: Every kernel the package defines, in definition order.
KERNELS: List["CudaKernel"] = []

_build_lock = threading.Lock()


class BuildResult(NamedTuple):
    library: Path
    log: str  # nvcc's output, with the -Xptxas -v resource lines
    seconds: float  # 0.0 when the library was already built
    cached: bool


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")


def build(source: str) -> BuildResult:
    """Compile ``csrc/<source>`` into a shared library, or reuse the one
    built from the same source and header bytes and flags. Raises
    ``RuntimeError`` with nvcc's output when the compile fails."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return BuildResult(lib, log.read_text() if log.is_file() else "", 0.0, True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=900,
    )
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{output}")
    log.write_text(output)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole library or none
    return BuildResult(lib, output, seconds, False)


class CudaKernel:
    """One hand-written kernel: its source, its C entry point, and the count
    of its launches (a launch that returned success adds one; nothing else
    does)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence[type], replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        #: ``file:line`` of the Pallas kernel this one replaces.
        self.replaces = replaces
        self._launches = 0
        self._fn = None
        self._error_string = None
        self._lock = threading.Lock()
        KERNELS.append(self)

    @property
    def source_path(self) -> str:
        """The source's path relative to the repository root."""
        return f"{PACKAGE_DIR.name}/{CSRC_DIR.name}/{self.source}"

    @property
    def launches(self) -> int:
        with self._lock:
            return self._launches

    def reset_launches(self) -> None:
        with self._lock:
            self._launches = 0

    def _entry(self):
        with _build_lock:
            if self._fn is None:
                import torch

                if not torch.cuda.is_available():
                    raise RuntimeError(f"{self.name}: no CUDA device is available")
                lib = ctypes.CDLL(str(build(self.source).library))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._error_string = err
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise if the launch was refused."""
        rc = self._entry()(*args)
        if rc != 0:
            raise RuntimeError(
                f"{self.name} launch failed: CUDA error {rc} "
                f"({self._error_string(rc).decode()})"
            )
        with self._lock:
            self._launches += 1


def check_tensor(name: str, t, shape, device, dtype=None) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` (float32 when
    None), the given shape and a contiguous layout: what a kernel's wrapper
    checks before it hands ``t.data_ptr()`` to a launch."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).replace('torch.', '')}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


from flink_ml_tpu_torch.native.chunk_store import (  # noqa: E402 — after BUILD_DIR, which it reads
    NativeChunkStore,
    load_datacache_lib,
    native_available,
)
