"""Training-state checkpointing — twin of ``flink_ml_tpu/checkpoint.py``.

A checkpoint is the iteration variables plus the epoch counter, taken
between epochs (``iteration/iteration.py`` calls ``save`` and
``restore_latest`` through ``IterationConfig.checkpoint_manager``).
``CheckpointManager`` writes each snapshot atomically and durably (a
``ckpt-N.tmp`` directory, an fsync of each file, the rename and an fsync of
the directory, ``META.json`` written last), keeps the newest
``max_to_keep`` and restores the newest *intact* one.

Corruption tolerance as in the JAX package: every leaf carries a CRC32 in
``META.json``; ``restore_latest`` quarantines a snapshot that fails to read
or verify as ``ckpt-N.corrupt`` and falls back to the next older one. A
missing or truncated snapshot raises the typed ``CheckpointCorruptError``
(step and path attached); a snapshot of a different run raises the typed
``FingerprintMismatchError`` and never falls back.

The on-disk layout is the JAX package's — ``ckpt-N/arrays.npz`` holding
``leaf_i`` and ``META.json`` with ``step``, ``num_leaves``, ``fingerprint``
and ``crc32s`` — except for the tree structure: the JAX package pickles a
JAX treedef, which needs JAX to read, so the port writes its own
``tree.json`` instead. It describes lists, tuples, dicts with string keys
(flattened in sorted key order, as JAX flattens dicts), ``None`` (no leaf)
and leaves, each leaf a torch tensor or an array. A tensor leaf is saved
from its device with ``.cpu()`` and restored as a tensor on the device the
caller names; any other leaf comes back as a numpy array, as in the JAX
package. The port's ``CheckpointManager`` does not restore a snapshot the
JAX package's wrote.

``ShardedCheckpointManager`` (JAX :345) is the mesh tier's: the JAX
package's ``sharded-v1`` format, which both packages read and write. META
records the mesh shape; a leaf held per rank (:class:`ShardedLeaf`) is
stored as ``leaf_{i}_piece_{j}`` entries with their global placement, and
every other leaf as ``leaf_{i}``. Beside ``tree.json`` it writes the tree
as the JAX package pickles it (``treedef.pkl``: a ``PyTreeDef``'s state,
written and read here without JAX by a restricted unpickler that resolves
no other global), so a snapshot crosses between the packages either way.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.metrics import MLMetrics, metrics

__all__ = [
    "CheckpointManager",
    "CheckpointCorruptError",
    "FingerprintMismatchError",
    "MeshMismatchError",
    "ShardedCheckpointManager",
    "ShardedLeaf",
    "scan_numbered_dirs",
]

_STEP_PREFIX = "ckpt-"
_CORRUPT_SUFFIX = ".corrupt"
_TREE_FILE = "tree.json"
_TREEDEF_FILE = "treedef.pkl"


def scan_numbered_dirs(directory: str, prefix: str = _STEP_PREFIX,
                       marker_file: str = "META.json") -> List[int]:
    """Numbers of the (apparently) complete ``<prefix><int>`` dirs, ascending.

    Shared by checkpoint restore and the serving ``ModelVersionPoller``:
    anything whose name does not parse as ``<prefix><int>`` — quarantined
    ``.corrupt`` dirs, in-flight ``.tmp`` dirs, stray files — is skipped,
    and a dir missing its ``marker_file`` (written last by every atomic
    publish here) counts as incomplete.
    """
    numbers = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        if not name.startswith(prefix):
            continue
        try:
            number = int(name[len(prefix):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, name, marker_file)):
            numbers.append(number)
    return sorted(numbers)


class CheckpointCorruptError(RuntimeError):
    """A snapshot is missing, truncated, or fails checksum verification."""

    def __init__(self, step: int, path: str, reason: str):
        self.step = step
        self.path = path
        self.reason = reason
        super().__init__(f"checkpoint step {step} at {path!r} is corrupt: {reason}")


class FingerprintMismatchError(ValueError):
    """A directory holds snapshots of a *different* run or config: fatal,
    since falling back would resume another job's state."""


class MeshMismatchError(ValueError):
    """A snapshot with per-rank leaves was saved on another mesh shape:
    fatal like a fingerprint mismatch, since no older snapshot fits either.
    Snapshots of replicated leaves only never raise it: they restore at any
    width."""


class ShardedLeaf:
    """A leaf held per rank: the pieces of a global array of ``shape`` that
    this rank holds, each ``(bounds, data)`` with ``bounds`` one ``(start,
    stop)`` per dimension and ``data`` a tensor or array of that extent.
    ``tensor`` (default: whether the first piece is a tensor) is how the
    reassembled leaf is restored."""

    __slots__ = ("shape", "pieces", "tensor")

    def __init__(self, shape, pieces, tensor: Optional[bool] = None):
        self.shape = tuple(int(x) for x in shape)
        self.pieces = [(tuple((int(a), int(b)) for a, b in bounds), data) for bounds, data in pieces]
        self.tensor = isinstance(self.pieces[0][1], torch.Tensor) if tensor is None else bool(tensor)

    def host_pieces(self) -> List[Tuple[tuple, np.ndarray]]:
        return [
            (bounds, data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data))
            for bounds, data in self.pieces
        ]


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _flatten(tree: Any, leaves: List[np.ndarray]):
    """Append ``tree``'s leaves (as host arrays) to ``leaves`` in JAX's
    flattening order and return its ``tree.json`` description."""
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(x, leaves) for x in tree]}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"checkpointed dicts need string keys, got {sorted(map(repr, tree))}")
        return {"dict": {k: _flatten(tree[k], leaves) for k in sorted(tree)}}
    if tree is None:
        return {"none": None}
    if isinstance(tree, ShardedLeaf):
        leaves.append(tree)
        return {"leaf": "tensor" if tree.tensor else "array"}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().numpy())
        return {"leaf": "tensor"}
    leaves.append(np.asarray(tree))
    return {"leaf": "array"}


def _unflatten(spec, leaves: Iterator[np.ndarray], device: torch.device):
    if "list" in spec:
        return [_unflatten(s, leaves, device) for s in spec["list"]]
    if "tuple" in spec:
        return tuple(_unflatten(s, leaves, device) for s in spec["tuple"])
    if "dict" in spec:
        return {k: _unflatten(spec["dict"][k], leaves, device) for k in sorted(spec["dict"])}
    if "none" in spec:
        return None
    leaf = next(leaves)
    return torch.from_numpy(leaf).to(device) if spec["leaf"] == "tensor" else leaf


def _write_synced(path: str, data) -> None:
    with open(path, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


# --- the JAX package's pickled treedef, without JAX --------------------------
#
# A pickled ``PyTreeDef`` is ``PyTreeDef()`` with the state ``(registry,
# nodes)``: the nodes in post-order, each ``(kind, arity, node_data, custom,
# num_leaves, num_nodes)``. The kinds this tree description covers: leaf 0,
# None 1, tuple 2, list 4, dict 5 (node_data: the sorted keys).

_KIND_LEAF, _KIND_NONE, _KIND_TUPLE, _KIND_LIST, _KIND_DICT = 0, 1, 2, 4, 5


def _treedef_nodes(spec, out: list) -> Tuple[int, int]:
    """Append ``spec``'s nodes in post-order; returns (leaves, nodes)."""
    if "leaf" in spec:
        out.append((_KIND_LEAF, 0, None, None, 1, 1))
        return 1, 1
    if "none" in spec:
        out.append((_KIND_NONE, 0, None, None, 0, 1))
        return 0, 1
    if "dict" in spec:
        keys = sorted(spec["dict"])
        kind, data, children = _KIND_DICT, list(keys), [spec["dict"][k] for k in keys]
    else:
        kind = _KIND_LIST if "list" in spec else _KIND_TUPLE
        data, children = None, spec["list" if kind == _KIND_LIST else "tuple"]
    n_leaves = n_nodes = 0
    for child in children:
        a, b = _treedef_nodes(child, out)
        n_leaves, n_nodes = n_leaves + a, n_nodes + b
    out.append((kind, len(children), data, None, n_leaves, n_nodes + 1))
    return n_leaves, n_nodes + 1


def _treedef_pickle(spec) -> bytes:
    """The bytes ``pickle.dumps`` gives for the JAX treedef of ``spec``
    (protocol 2, written opcode by opcode: ``PyTreeDef()`` then BUILD with
    ``(default_registry, nodes)``)."""
    nodes: list = []
    _treedef_nodes(spec, nodes)
    body = pickle.dumps(nodes, protocol=2)[2:-1]  # the list, without PROTO and STOP
    return (b"\x80\x02cjaxlib._jax.pytree\nPyTreeDef\n)\x81"
            b"cjax._src.tree_util\ndefault_registry\n" + body + b"\x86b.")


class _PyTreeDefState:
    """Stands in for ``PyTreeDef`` while unpickling: keeps BUILD's state."""

    def __setstate__(self, state):
        self.nodes = state[1]


class _TreedefUnpickler(pickle.Unpickler):
    """Resolves the two globals a pickled treedef names, and nothing else."""

    def find_class(self, module, name):
        if name == "PyTreeDef" and module.endswith("pytree"):
            return _PyTreeDefState
        if name == "default_registry" and module.endswith("tree_util"):
            return None
        raise pickle.UnpicklingError(f"{module}.{name} is not part of a pickled treedef")


def _spec_from_treedef(data: bytes):
    """The ``tree.json`` description of a pickled JAX treedef (every leaf an
    array)."""
    nodes = _TreedefUnpickler(io.BytesIO(data)).load().nodes
    stack: list = []
    for kind, arity, node_data, _custom, _leaves, _nodes in nodes:
        if kind == _KIND_LEAF:
            stack.append({"leaf": "array"})
        elif kind == _KIND_NONE:
            stack.append({"none": None})
        else:
            children = stack[len(stack) - arity:]
            del stack[len(stack) - arity:]
            if kind == _KIND_LIST:
                stack.append({"list": children})
            elif kind == _KIND_TUPLE:
                stack.append({"tuple": children})
            elif kind == _KIND_DICT:
                stack.append({"dict": dict(zip(node_data, children))})
            else:
                raise ValueError(f"treedef node kind {kind} (a namedtuple or custom node) is not read here")
    if len(stack) != 1:
        raise ValueError("treedef nodes do not form one tree")
    return stack[0]


class CheckpointManager:
    """Numbered atomic snapshots of a tree of tensors and arrays under
    ``directory``.

    ``fingerprint`` is a run/config identity string, recorded in each
    snapshot's ``META.json``; ``restore_latest`` refuses a snapshot whose
    fingerprint differs, so a different job pointed at an existing
    directory raises instead of resuming stale state.
    """

    def __init__(self, directory: str, max_to_keep: int = 2, fingerprint: Optional[str] = None):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.fingerprint = fingerprint
        self._user_pinned = fingerprint is not None
        os.makedirs(directory, exist_ok=True)
        self._sweep_orphan_tmp()

    def _sweep_orphan_tmp(self) -> None:
        """Reclaim the ``ckpt-N.tmp`` a kill mid-save left: at construction
        any such entry is from a dead incarnation, never a concurrent save."""
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) and name.endswith(".tmp"):
                path = os.path.join(self.directory, name)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)
                    except OSError:
                        continue
                metrics.counter(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_TMP_SWEPT)

    def set_fingerprint(self, fingerprint: str) -> None:
        """Install the run identity an algorithm computed. A fingerprint
        pinned at construction wins; an installed one is overwritten on each
        call, so one manager reused across differently configured runs
        still trips the stale-resume guard."""
        if not self._user_pinned:
            self.fingerprint = fingerprint

    # --- write ---------------------------------------------------------------
    def save(self, step: int, state: Any) -> str:
        """Snapshot ``state`` as checkpoint ``step`` (tensors fetched to the
        host); a kill or power loss mid-save never leaves a snapshot that
        ``restore_latest`` would pick up. Returns the snapshot's directory."""
        leaves: List[np.ndarray] = []
        tree = _flatten(state, leaves)
        meta = {
            "step": step,
            "num_leaves": len(leaves),
            "fingerprint": self.fingerprint,
            "crc32s": [_crc(leaf) for leaf in leaves],
        }
        return self._write_snapshot(step, {f"leaf_{i}": x for i, x in enumerate(leaves)},
                                    {_TREE_FILE: json.dumps(tree)}, meta)

    def _write_snapshot(self, step: int, entries: Dict[str, np.ndarray], files: Dict[str, Any],
                        meta: dict) -> str:
        """Write ``arrays.npz`` of ``entries``, each of ``files``, then
        META.json last, into ``ckpt-N.tmp``; fsync and rename it into place."""
        final_dir = self._step_dir(step)
        tmp_dir = final_dir + ".tmp"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        np.savez(os.path.join(tmp_dir, "arrays.npz"), **entries)
        for name, data in files.items():
            _write_synced(os.path.join(tmp_dir, name), data)
        _write_synced(os.path.join(tmp_dir, "META.json"), json.dumps(meta))
        _fsync_path(os.path.join(tmp_dir, "arrays.npz"))
        _fsync_path(tmp_dir)
        if os.path.exists(final_dir):
            shutil.rmtree(final_dir)
        os.rename(tmp_dir, final_dir)
        _fsync_path(self.directory)
        self._prune()
        return final_dir

    # --- read ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Steps of the (apparently) complete snapshots, ascending."""
        return scan_numbered_dirs(self.directory)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step}")

    def _read_meta(self, step: int) -> dict:
        ckpt_dir = self._step_dir(step)
        try:
            with open(os.path.join(ckpt_dir, "META.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:  # missing, truncated, bad JSON
            raise CheckpointCorruptError(step, ckpt_dir, f"META.json unreadable: {e!r}")

    def restore(self, step: int, device=None) -> Any:
        """Load and verify snapshot ``step``; tensor leaves land on
        ``device`` (None → the CPU). Any unreadable, truncated or
        checksum-failing snapshot raises ``CheckpointCorruptError``."""
        ckpt_dir = self._step_dir(step)
        meta = self._read_meta(step)
        try:
            with open(os.path.join(ckpt_dir, _TREE_FILE)) as f:
                tree = json.load(f)
            with np.load(os.path.join(ckpt_dir, "arrays.npz")) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        except Exception as e:  # OSError, KeyError, BadZipFile, JSONDecodeError, ...
            raise CheckpointCorruptError(step, ckpt_dir, f"snapshot unreadable: {e!r}")
        expected = meta.get("num_leaves")
        if expected is not None and expected != len(leaves):
            raise CheckpointCorruptError(
                step, ckpt_dir, f"expected {expected} leaves, found {len(leaves)}"
            )
        for i, (leaf, crc) in enumerate(zip(leaves, meta.get("crc32s") or ())):
            actual = _crc(leaf)
            if actual != crc:
                raise CheckpointCorruptError(
                    step, ckpt_dir,
                    f"leaf_{i} checksum mismatch (crc32 {actual:#x} != recorded {crc:#x})",
                )
        try:
            return _unflatten(tree, iter(leaves), torch.device("cpu" if device is None else device))
        except (KeyError, TypeError, StopIteration) as e:
            raise CheckpointCorruptError(step, ckpt_dir, f"{_TREE_FILE} does not match the leaves: {e!r}")

    def _check_fingerprint(self, meta: dict) -> None:
        saved = meta.get("fingerprint")
        if saved is not None and self.fingerprint is not None and saved != self.fingerprint:
            raise FingerprintMismatchError(
                f"checkpoint directory {self.directory!r} holds snapshots of a different "
                f"run (fingerprint {saved!r} != {self.fingerprint!r}); point this job at "
                "a fresh directory or delete the stale checkpoints"
            )

    def _quarantine(self, step: int) -> None:
        """Move a corrupt snapshot aside as ``ckpt-N.corrupt``: kept for
        forensics, invisible to ``all_steps``."""
        src = self._step_dir(step)
        dst = src + _CORRUPT_SUFFIX
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}{_CORRUPT_SUFFIX}.{n}"
        try:
            os.rename(src, dst)
        except OSError:
            shutil.rmtree(src, ignore_errors=True)
        metrics.counter(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_QUARANTINED)

    def restore_latest(self, device=None) -> Optional[Tuple[int, Any]]:
        """``(step, state)`` of the newest *intact* snapshot, or None. A
        snapshot that fails verification is quarantined and the next older
        one is tried; a fingerprint mismatch raises."""
        fell_back = False
        for step in reversed(self.all_steps()):
            try:
                meta = self._read_meta(step)
            except CheckpointCorruptError:
                self._quarantine(step)
                fell_back = True
                continue
            self._check_fingerprint(meta)
            try:
                state = self.restore(step, device)
            except CheckpointCorruptError:
                self._quarantine(step)
                fell_back = True
                continue
            if fell_back:
                metrics.counter(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_FALLBACKS)
            return step, state
        return None

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[: -self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._step_dir(step))


def _mesh_shape(sharding) -> Optional[Tuple[int, int]]:
    if sharding is None:
        return None
    if isinstance(sharding, tuple):
        return int(sharding[0]), int(sharding[1])
    return int(sharding.n_data), int(sharding.n_model)


class ShardedCheckpointManager(CheckpointManager):
    """Snapshots of mesh training state in the JAX package's ``sharded-v1``
    format — a drop-in for ``CheckpointManager`` wherever the iteration
    loop takes one, with the same atomicity, CRC32, quarantine and
    fallback.

    On a mesh every rank calls ``save`` and ``restore_latest`` with the same
    step: rank 0 writes (the pieces of :class:`ShardedLeaf` leaves gathered
    to it from every rank, deduplicated by placement) while the others wait
    at a barrier, and every rank restores. Only rank 0 sweeps orphan
    ``.tmp`` directories, prunes and quarantines.

    ``sharding``: a ``TrainSharding`` or ``MeshContext`` (its ``n_data`` and
    ``n_model`` are the mesh shape, its process group the one that saves),
    or an ``(n_data, n_model)`` tuple; None skips the mesh check. A snapshot
    whose leaves are all replicated restores at any width; one with pieces
    saved on another mesh shape raises ``MeshMismatchError``.
    """

    _FORMAT = "sharded-v1"

    def __init__(self, directory: str, max_to_keep: int = 2, fingerprint: Optional[str] = None,
                 sharding=None):
        import torch.distributed as dist

        self.mesh_shape = _mesh_shape(sharding)
        ctx = getattr(sharding, "ctx", sharding)
        self._group = getattr(ctx, "group", None)
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world = dist.get_rank(self._group), dist.get_world_size(self._group)
        else:
            self.rank, self.world = 0, 1
        super().__init__(directory, max_to_keep=max_to_keep, fingerprint=fingerprint)

    def _barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self._group)

    def _sweep_orphan_tmp(self) -> None:
        if self.rank == 0:
            super()._sweep_orphan_tmp()

    def _gathered_pieces(self, leaf: ShardedLeaf) -> List[Tuple[tuple, np.ndarray]]:
        """Every rank's pieces of ``leaf``, one per placement, in order."""
        pieces = leaf.host_pieces()
        if self.world > 1:
            import torch.distributed as dist

            got: list = [None] * self.world
            dist.all_gather_object(got, pieces, group=self._group)
            pieces = [p for rank_pieces in got for p in rank_pieces]
        return sorted(dict(pieces).items())

    def save(self, step: int, state: Any) -> str:
        leaves: list = []
        tree = _flatten(state, leaves)
        entries: Dict[str, np.ndarray] = {}
        descs: List[Optional[dict]] = []
        for i, leaf in enumerate(leaves):
            if not isinstance(leaf, ShardedLeaf):
                entries[f"leaf_{i}"] = leaf
                descs.append(None)
                continue
            pieces = self._gathered_pieces(leaf)
            descs.append({
                "shape": list(leaf.shape),
                "dtype": pieces[0][1].dtype.name,
                "pieces": [[list(b) for b in bounds] for bounds, _ in pieces],
            })
            for j, (_bounds, piece) in enumerate(pieces):
                entries[f"leaf_{i}_piece_{j}"] = piece
        final_dir = self._step_dir(step)
        if self.rank == 0:
            n_pieces = sum(len(d["pieces"]) for d in descs if d is not None)
            if n_pieces:
                metrics.counter(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_SHARD_PIECES, n_pieces)
            meta = {
                "format": self._FORMAT,
                "step": step,
                "num_leaves": len(leaves),
                "fingerprint": self.fingerprint,
                "mesh": list(self.mesh_shape) if self.mesh_shape else None,
                "leaves": descs,
                "crc32s": {name: _crc(x) for name, x in entries.items()},
            }
            files = {_TREE_FILE: json.dumps(tree), _TREEDEF_FILE: _treedef_pickle(tree)}
            self._write_snapshot(step, entries, files, meta)
        self._barrier()
        return final_dir

    def restore(self, step: int, device=None) -> Any:
        ckpt_dir = self._step_dir(step)
        meta = self._read_meta(step)
        if meta.get("format") != self._FORMAT:
            # a directory that started on the plain manager
            return super().restore(step, device)
        try:
            tree_path = os.path.join(ckpt_dir, _TREE_FILE)
            if os.path.exists(tree_path):
                with open(tree_path) as f:
                    tree = json.load(f)
            else:  # written by the JAX package
                with open(os.path.join(ckpt_dir, _TREEDEF_FILE), "rb") as f:
                    tree = _spec_from_treedef(f.read())
            with np.load(os.path.join(ckpt_dir, "arrays.npz")) as z:
                data = {name: z[name] for name in z.files}
        except Exception as e:  # OSError, BadZipFile, UnpicklingError, JSONDecodeError, ...
            raise CheckpointCorruptError(step, ckpt_dir, f"snapshot unreadable: {e!r}")
        for name, crc in (meta.get("crc32s") or {}).items():
            if name not in data:
                raise CheckpointCorruptError(step, ckpt_dir, f"{name} missing")
            actual = _crc(data[name])
            if actual != crc:
                raise CheckpointCorruptError(
                    step, ckpt_dir, f"{name} checksum mismatch (crc32 {actual:#x} != recorded {crc:#x})"
                )
        descs = meta.get("leaves")
        if descs is None or len(descs) != meta.get("num_leaves"):
            raise CheckpointCorruptError(step, ckpt_dir, "leaf descriptor table missing or truncated")
        saved_mesh = meta.get("mesh")
        if (
            any(d is not None for d in descs)
            and self.mesh_shape is not None
            and saved_mesh is not None
            and tuple(saved_mesh) != self.mesh_shape
        ):
            raise MeshMismatchError(
                f"checkpoint step {step} holds per-shard leaves saved on mesh {tuple(saved_mesh)}, "
                f"but this run's train mesh is {self.mesh_shape}; resume on the saved mesh shape "
                "or start from a fresh directory"
            )
        leaves = []
        for i, desc in enumerate(descs):
            if desc is None:
                if f"leaf_{i}" not in data:
                    raise CheckpointCorruptError(step, ckpt_dir, f"leaf_{i} missing")
                leaves.append(data[f"leaf_{i}"])
                continue
            out = np.zeros(tuple(desc["shape"]), np.dtype(desc["dtype"]))
            for j, bounds in enumerate(desc["pieces"]):
                name = f"leaf_{i}_piece_{j}"
                if name not in data:
                    raise CheckpointCorruptError(step, ckpt_dir, f"{name} missing")
                out[tuple(slice(a, b) for a, b in bounds)] = data[name]
            leaves.append(out)
        try:
            return _unflatten(tree, iter(leaves), torch.device("cpu" if device is None else device))
        except (KeyError, TypeError, StopIteration) as e:
            raise CheckpointCorruptError(step, ckpt_dir, f"the tree does not match the leaves: {e!r}")

    def _quarantine(self, step: int) -> None:
        if self.rank == 0:
            super()._quarantine(step)
