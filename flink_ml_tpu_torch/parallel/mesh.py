"""The training mesh of processes — twin of ``flink_ml_tpu/parallel/mesh.py``.

The JAX package's "cluster" is one controller driving a ``jax.sharding.Mesh``
of devices laid out ``[slice, data, model]``. The port's is a
``torch.distributed`` process group: a user starts ``n_slices · n_data ·
n_model`` processes (``torchrun --nproc-per-node N`` or
``torch.multiprocessing``), each holding one device, and every process runs
the same program on the same whole input. A :class:`MeshContext` is one
process's view of that group: the rank's place in the grid ``[slice, data,
model]`` (model innermost, as JAX reshapes its devices), its
``data_index`` / ``model_index`` / ``slice_index``, the rank's device, and
one process subgroup per axis:

- ``"model"``: the ranks of one data index (tensor parallelism: a margin
  all-reduced over the model shards of one row shard never leaves a slice);
- ``data_axes``: the ranks of one model index across every slice — the
  gradient's all-reduce (``("slice", "data")`` on a multi-slice mesh, plain
  ``"data"`` otherwise);
- ``"data"`` on a multi-slice mesh: the ranks of one model index in one
  slice.

``n_data`` counts every data shard (``n_slices`` times the per-slice width,
as in JAX): rows, local batches and caches see slices as extra data
shards. Every rank asks for every subgroup, in the same order, in
``__init__`` — ``dist.new_group`` must be called by every rank of the world
for every group, or the world hangs. A group is made the first time a mesh
of the world needs it and reused by every later mesh (a fit builds its own
``MeshContext``), so a process that retrains holds one set of groups, not
one a fit.

The subgroups and the installed mesh are dropped at exit
(:func:`release_groups`), so the groups ``dist.destroy_process_group`` left
behind are destroyed, and their gloo worker threads joined, while the
interpreter still runs: a worker thread that outlives it may drop the last
reference to a tensor during finalisation and abort the process.

Width 1 needs no process group: a ``MeshContext`` of one shard runs the
same programs with every collective skipped, which is what makes an explicit
``train.mesh = 1`` the reference the wider meshes are held to.

The JAX module's ``is_tpu_backend``, ``vma_of`` and ``shape_dtype_struct``
describe JAX's own tracing (the Mosaic target and shard_map's varying-axes
annotations) and have no counterpart here.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
import os
import threading
from typing import Optional, Union

import torch
import torch.distributed as dist

from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "SLICE_AXIS",
    "MeshContext",
    "get_mesh_context",
    "mesh_context",
    "rank_device",
    "release_groups",
    "sequence_mesh",
    "set_mesh_context",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"

_lock = threading.Lock()
_current: Optional["MeshContext"] = None
# The axis subgroups made so far, by their members' global ranks, and the
# default process group they were made in: every MeshContext of a world
# reuses them, so a process that fits again and again makes each group once.
_groups: dict = {}
_groups_world = None
_groups_lock = threading.Lock()  # apart from _lock, which get_mesh_context holds while it builds a mesh


def _subgroup(ranks: list):
    """The process subgroup of ``ranks`` (global ranks), made by
    ``dist.new_group`` the first time any mesh of this world asks for it.
    Every rank runs the same meshes in the same order, so every rank makes
    the same groups in the same order and reuses the same ones."""
    global _groups_world
    with _groups_lock:
        world = dist.group.WORLD
        if _groups_world is not world:  # a new default group: the old subgroups are gone with it
            _groups.clear()
            _groups_world = world
        key = tuple(ranks)
        if key not in _groups:
            _groups[key] = dist.new_group(list(ranks))
        return _groups[key]


def release_groups() -> None:
    """Drop the axis subgroups kept here, the default group they were made
    in and the installed mesh (registered to run at exit). A group whose
    last reference goes is destroyed and its worker threads joined; a gloo
    worker thread still running when the interpreter finalises may release
    a tensor then, which aborts the process ("terminate called without an
    active exception")."""
    global _groups_world, _current
    with _groups_lock:
        held = _groups_world is not None  # subgroups were made (a mesh of one axis holds none)
        _groups.clear()
        _groups_world = None
    with _lock:
        _current = None
    if held:
        gc.collect()  # a mesh in a reference cycle holds its subgroups as well


atexit.register(release_groups)


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
    """One rank's view of the training mesh ``[slice, data, model]``.

    ``n_data`` is the per-slice data width (None: ``mesh.data.axis.size``,
    unset by default, else the world divided by ``n_model · n_slices``) and
    ``n_model`` the model width (None: ``mesh.model.axis.size``, 1 by
    default), as the JAX package's ``MeshContext`` reads them; the mesh must hold exactly the process group's
    ranks (1 without a group): a mesh narrower or wider than the processes
    that run it would train on rows no rank holds, or hold rows twice.
    ``group`` None is the default process group; a mesh with a model or
    slice axis makes its subgroups over the default group and takes no
    other.
    """

    def __init__(self, n_data: Optional[int] = None, n_model: Optional[int] = None,
                 device: Optional[Union[str, torch.device]] = None, group=None, n_slices: int = 1):
        initialized, world, rank = _world()
        if initialized and group is not None:
            world, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_model is None:
            n_model = config.get(Options.MESH_MODEL_AXIS_SIZE)
        if n_data is None:
            n_data = config.get(Options.MESH_DATA_AXIS_SIZE)
        n_model, n_slices = int(n_model), int(n_slices)
        if n_data is None:
            n_data = max(1, world // (n_model * n_slices))
        if n_data < 1 or n_model < 1 or n_slices < 1:
            raise ValueError(f"train mesh axes must be >= 1, got {n_slices}x{n_data}x{n_model}")
        need = n_slices * n_data * n_model
        if need != world:
            raise ValueError(
                f"train.mesh {n_data}x{n_model}{f' on {n_slices} slices' if n_slices > 1 else ''} "
                f"needs a process group of {need} ranks, this process sees {world}; start {need} "
                f"processes (torchrun --nproc-per-node {need}) or set train.mesh and "
                "train.mesh.model to the world size"
            )
        if group is not None and (n_model > 1 or n_slices > 1) and world != dist.get_world_size():
            raise ValueError("a mesh with a model or slice axis is made over the default process group")
        self.group = group
        self.distributed = initialized
        self.n_slices = n_slices
        self.n_data = n_slices * int(n_data)  # every data shard, slices included (JAX :113)
        self.n_model = n_model
        self.rank = rank
        self.backend = dist.get_backend(group) if initialized else None
        self.device = rank_device(device, rank)
        if self.backend == "nccl":
            torch.cuda.set_device(self.device)  # NCCL's collectives run on the current card
        self._axes = self._make_groups(int(n_data)) if initialized else {}

    n_slices = 1
    _axes: dict = {}

    @property
    def data_index(self) -> int:
        """The rank's data shard, slices included (``rank // n_model``)."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def slice_index(self) -> int:
        return self.data_index // (self.n_data // self.n_slices)

    def _make_groups(self, n_data_slice: int) -> dict:
        """``{axis: (group, global ranks)}`` for this rank. Every rank asks
        for every group of every axis, in one order (``_subgroup``: made
        once a world, reused by every later mesh)."""
        nm, nd = self.n_model, self.n_data
        if nm == 1 and self.n_slices == 1:
            ranks = dist.get_process_group_ranks(self.group) if self.group is not None else list(range(nd))
            return {DATA_AXIS: (self.group, ranks)}

        def mine(rank_sets):
            got = None
            for ranks in rank_sets:
                g = _subgroup(ranks)
                if self.rank in ranks:
                    got = (g, ranks)
            return got

        axes = {}
        if nm > 1:  # one group per data index: its model shards
            axes[MODEL_AXIS] = mine([[d * nm + m for m in range(nm)] for d in range(nd)])
        # one group per model index: its data shards over every slice
        all_data = [[d * nm + m for d in range(nd)] for m in range(nm)]
        axes[self.data_axes] = (self.group, all_data[0]) if nm == 1 else mine(all_data)
        if self.n_slices > 1:  # one group per (slice, model index)
            axes[DATA_AXIS] = mine([[(s * n_data_slice + d) * nm + m for d in range(n_data_slice)]
                                    for s in range(self.n_slices) for m in range(nm)])
        return axes

    @property
    def data_axes(self):
        """The axes a batch shards over: ``("slice", "data")`` on a
        multi-slice mesh, ``"data"`` otherwise (JAX :116)."""
        return (SLICE_AXIS, DATA_AXIS) if self.n_slices > 1 else DATA_AXIS

    def axis_ranks(self, axis=None) -> tuple:
        """``(group, ranks)``: the process group of ``axis`` (``"model"``,
        ``"data"``, ``("slice", "data")``; None → :attr:`data_axes`) that
        holds this rank, and its members' global ranks in axis order."""
        axis = self.data_axes if axis is None else axis
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            if axis == (DATA_AXIS,) or (axis == (SLICE_AXIS, DATA_AXIS) and self.n_slices == 1):
                axis = DATA_AXIS
        if axis not in (MODEL_AXIS, DATA_AXIS, (SLICE_AXIS, DATA_AXIS)):
            raise ValueError(f"no mesh axis {axis!r} on {self!r}")
        if axis not in self._axes:  # an axis of one rank
            return None, [dist.get_rank() if self.distributed else 0]
        return self._axes[axis]

    def axis_group(self, axis=None) -> tuple:
        """``(group, size)`` of the collective over ``axis`` that holds this
        rank (:meth:`axis_ranks`). Size 1 means no collective."""
        group, ranks = self.axis_ranks(axis)
        return group, len(ranks)

    def axis_index(self, axis=None) -> int:
        """This rank's position on ``axis`` (JAX ``lax.axis_index``)."""
        _group, ranks = self.axis_ranks(axis)
        return ranks.index(dist.get_rank()) if self.distributed else 0

    @property
    def host_staged(self) -> bool:
        """Whether collectives stage through host buffers: gloo on a CUDA
        device (ranks sharing a card, where NCCL refuses them)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def local_range(self, n: int) -> tuple:
        """``(lo, hi, m)``: this rank's contiguous rows ``[lo, hi)`` of ``n``
        rows padded to ``m = ceil(n / n_data)`` a data shard (``hi - lo < m``
        on the shard holding the padding). The ranks of one data index hold
        the same rows."""
        m = -(-n // self.n_data)
        lo = min(self.data_index * m, n)
        return lo, min(lo + m, n), m

    def model_range(self, d: int) -> tuple:
        """``(lo, hi, d_pad)``: this rank's slice ``[lo, hi)`` of a model axis
        of ``d`` entries padded to ``d_pad``, a multiple of ``n_model``
        (JAX ``optimizer.py:912``)."""
        d_pad = d + (-d) % self.n_model
        w = d_pad // self.n_model
        return self.model_index * w, (self.model_index + 1) * w, d_pad

    def replicate(self, array, dtype=None) -> torch.Tensor:
        """A copy of ``array`` on this rank's device (every rank holds the
        same host value, so no collective is needed)."""
        t = array if isinstance(array, torch.Tensor) else torch.as_tensor(array)
        return t.to(self.device, dtype=dtype)

    def __repr__(self) -> str:
        extra = f", slices={self.n_slices}" if self.n_slices > 1 else ""
        return (f"MeshContext(data={self.n_data}, model={self.n_model}{extra}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def get_mesh_context() -> MeshContext:
    """The process-global mesh; created on first use over the default
    process group (width 1 when there is none)."""
    global _current
    with _lock:
        if _current is None:
            _current = MeshContext()
        return _current


def sequence_mesh(device: Optional[Union[str, torch.device]] = None) -> Optional[MeshContext]:
    """The mesh a sequence-sharded stage splits its sequence over: None in a
    process with no group (one shard), else the installed global mesh or,
    when none is installed, the world's data axis on ``device``."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    with _lock:
        current = _current
    return current if current is not None else MeshContext(device=device)


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
