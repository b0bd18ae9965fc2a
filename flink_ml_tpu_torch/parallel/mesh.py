"""The training mesh of processes — twin of ``flink_ml_tpu/parallel/mesh.py``.

The JAX package's "cluster" is one controller driving a ``jax.sharding.Mesh``
of devices. The port's is a ``torch.distributed`` process group: a user
starts N processes (``torchrun --nproc-per-node N`` or
``torch.multiprocessing``), each holding one device, and every process runs
the same program on the same whole input. A :class:`MeshContext` is one
process's view of that group: the group, its rank, ``n_data`` (the world
size: every rank is one shard of the data axis), ``n_model`` (1: tensor
parallelism is not ported) and the rank's device.

Width 1 needs no process group: a ``MeshContext`` of one shard runs the
same programs with every collective skipped, which is what makes an explicit
``train.mesh = 1`` the reference the wider meshes are held to.

The JAX module's ``is_tpu_backend``, ``vma_of`` and ``shape_dtype_struct``
describe JAX's own tracing (the Mosaic target and shard_map's varying-axes
annotations) and have no counterpart here.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist

from flink_ml_tpu_torch.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshContext",
    "get_mesh_context",
    "mesh_context",
    "rank_device",
    "set_mesh_context",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_lock = threading.Lock()
_current: Optional["MeshContext"] = None

_TP_NOT_PORTED = (
    "tensor parallelism (train.mesh.model > 1) is not ported to the PyTorch "
    "package yet (see ROADMAP.md, queue A 6)"
)


def _world() -> tuple:
    """``(initialized, world size, rank)`` of the default process group."""
    if dist.is_available() and dist.is_initialized():
        return True, dist.get_world_size(), dist.get_rank()
    return False, 1, 0


def rank_device(device: Optional[Union[str, torch.device]] = None, rank: Optional[int] = None) -> torch.device:
    """The device a rank trains on. ``"cpu"`` stays the CPU; ``None`` or
    ``"cuda"`` without an index is the card of this rank's local index
    (``LOCAL_RANK`` as torchrun sets it, else the rank) modulo the cards
    visible, so ranks beyond the card count share cards; an indexed device
    is taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device("cuda")  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", _world()[2] if rank is None else rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


class MeshContext:
    """One rank's view of the training mesh.

    ``n_data`` must equal the process group's world size (1 without a
    group): a mesh narrower or wider than the processes that run it would
    train on rows no rank holds, or hold rows twice. ``n_model`` must be 1.
    ``group`` None is the default process group.
    """

    def __init__(self, n_data: Optional[int] = None, n_model: int = 1,
                 device: Optional[Union[str, torch.device]] = None, group=None):
        if n_model != 1:
            raise NotImplementedError(_TP_NOT_PORTED)
        initialized, world, rank = _world()
        if initialized and group is not None:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_data is None:
            n_data = world
        if n_data < 1:
            raise ValueError(f"train mesh axes must be >= 1, got {n_data}x{n_model}")
        if n_data != world:
            raise ValueError(
                f"train.mesh {n_data}x{n_model} needs a process group of {n_data} ranks, "
                f"this process sees {world}; start {n_data} processes (torchrun "
                f"--nproc-per-node {n_data}) or set train.mesh to the world size"
            )
        self.group = group
        self.distributed = initialized
        self.n_data = int(n_data)
        self.n_model = 1
        self.rank = rank
        self.backend = dist.get_backend(group) if initialized else None
        self.device = rank_device(device, rank)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)  # NCCL's collectives run on the current card

    @property
    def host_staged(self) -> bool:
        """Whether collectives stage through host buffers: gloo on a CUDA
        device (ranks sharing a card, where NCCL refuses them)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def local_range(self, n: int) -> tuple:
        """``(lo, hi, m)``: this rank's contiguous rows ``[lo, hi)`` of ``n``
        rows padded to ``m = ceil(n / n_data)`` a rank (``hi - lo < m`` on
        the rank holding the padding)."""
        m = -(-n // self.n_data)
        lo = min(self.rank * m, n)
        return lo, min(lo + m, n), m

    def replicate(self, array, dtype=None) -> torch.Tensor:
        """A copy of ``array`` on this rank's device (every rank holds the
        same host value, so no collective is needed)."""
        t = array if isinstance(array, torch.Tensor) else torch.as_tensor(array)
        return t.to(self.device, dtype=dtype)

    def __repr__(self) -> str:
        return (f"MeshContext(data={self.n_data}, model={self.n_model}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def get_mesh_context() -> MeshContext:
    """The process-global mesh; created on first use over the default
    process group (width 1 when there is none)."""
    global _current
    with _lock:
        if _current is None:
            _current = MeshContext()
        return _current


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    global _current
    with _lock:
        _current = ctx


@contextlib.contextmanager
def mesh_context(ctx: MeshContext):
    """Install ``ctx`` as the global mesh for the block."""
    global _current
    with _lock:
        prev, _current = _current, ctx
    try:
        yield ctx
    finally:
        with _lock:
            _current = prev
