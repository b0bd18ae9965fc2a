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
package. The port does not restore a snapshot the JAX package wrote.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.metrics import MLMetrics, metrics

__all__ = [
    "CheckpointManager",
    "CheckpointCorruptError",
    "FingerprintMismatchError",
    "scan_numbered_dirs",
]

_STEP_PREFIX = "ckpt-"
_CORRUPT_SUFFIX = ".corrupt"
_TREE_FILE = "tree.json"


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


def _write_synced(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


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
        final_dir = self._step_dir(step)
        tmp_dir = final_dir + ".tmp"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        np.savez(os.path.join(tmp_dir, "arrays.npz"), **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        _write_synced(os.path.join(tmp_dir, _TREE_FILE), json.dumps(tree))
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
