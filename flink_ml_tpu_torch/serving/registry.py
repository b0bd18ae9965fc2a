"""Versioned model registry: atomic hot swap and directory polling — twin
of ``flink_ml_tpu/serving/registry.py``.

- **Publish** (trainer side): ``publish_servable`` saves the stage into
  ``<dir>/v-<N>.tmp`` and renames it to ``v-<N>``, so a poller never sees
  a half-written version.
- **Discover** (``ModelVersionPoller``): the listing is the checkpoint
  tier's ``scan_numbered_dirs`` — ``.tmp``, ``.corrupt`` and unparsable
  names are skipped, and a version counts once its ``metadata`` exists.
- **Load off the serving path**: the poller's thread loads and warms the
  new servable while the old one serves; only then does
  ``ModelRegistry.swap`` flip one pair, which a batch snapshots once, so
  every response comes from one fully loaded version.
- **Fall back**: a version that fails to load or warm is remembered in
  ``failed`` and the next older intact one is tried.

Not ported yet (ROADMAP.md, queue A 10): ``quarantine_version``, the
``serving.swap`` fault point, the telemetry journal, and publishing at a
reduced precision.
"""
from __future__ import annotations

import os
import random
import shutil
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from flink_ml_tpu_torch.checkpoint import scan_numbered_dirs
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.serving.errors import NoModelError

__all__ = ["ModelRegistry", "ModelVersionPoller", "publish_servable"]

VERSION_PREFIX = "v-"
_METADATA_MARKER = "metadata"  # written by save_metadata; the last file of a stage save


def publish_servable(stage, directory: str, version: Optional[int] = None, *,
                     precision: Optional[str] = None) -> str:
    """Save ``stage`` (anything with ``.save``) as the next model version
    under ``directory``, atomically (tmp dir + rename). Returns the
    published path; an existing version raises ``FileExistsError``.
    ``precision`` None or ``"f32"`` publishes the stage as it is."""
    if precision in ("bf16", "int8"):
        raise NotImplementedError(
            f"publishing at precision {precision!r} is not ported to the PyTorch "
            "package yet (see ROADMAP.md, queue A 10)"
        )
    if precision not in (None, "f32"):
        raise ValueError(f"unknown publish precision {precision!r}")
    os.makedirs(directory, exist_ok=True)
    if version is None:
        published = scan_numbered_dirs(directory, VERSION_PREFIX, _METADATA_MARKER)
        version = (published[-1] + 1) if published else 1
    final_dir = os.path.join(directory, f"{VERSION_PREFIX}{version}")
    if os.path.exists(final_dir):
        raise FileExistsError(f"model version {version} already published at {final_dir}")
    tmp_dir = final_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    stage.save(tmp_dir)
    os.rename(tmp_dir, final_dir)
    return final_dir


class ModelRegistry:
    """Holds the serving ``(version, servable)`` pair; ``swap`` is atomic and
    publishes ``ml.model.version``, ``ml.model.timestamp`` and
    ``ml.serving.swaps`` under the server's scope."""

    def __init__(self, scope: str):
        self.scope = scope
        self._lock = threading.Lock()
        self._current: Optional[Tuple[int, object]] = None

    @property
    def version(self) -> Optional[int]:
        with self._lock:
            current = self._current
        return current[0] if current else None

    def current(self) -> Tuple[int, object]:
        """The serving pair, snapshotted once per batch."""
        with self._lock:
            current = self._current
        if current is None:
            raise NoModelError("no model version loaded yet")
        return current

    def swap(self, version: int, servable, *, allow_rollback: bool = False) -> None:
        """Atomically install ``(version, servable)``. Versions must advance,
        so a response's ``model_version`` is unambiguous — except under
        ``allow_rollback``, the controlled revert to an OLDER version
        (``InferenceServer.rollback``); never to the serving version itself,
        which would make two servables indistinguishable in responses."""
        with self._lock:
            previous = self._current
            if previous is not None and version == previous[0]:
                raise ValueError(f"hot swap must advance the version: {version} is already serving")
            if previous is not None and version < previous[0] and not allow_rollback:
                raise ValueError(
                    f"hot swap must advance the version: {version} <= serving {previous[0]}"
                )
            self._current = (version, servable)
        metrics.gauge(self.scope, MLMetrics.VERSION, version)
        metrics.gauge(self.scope, MLMetrics.TIMESTAMP, int(time.time() * 1000))
        metrics.counter(self.scope, MLMetrics.SERVING_SWAPS)


class ModelVersionPoller:
    """Watch ``directory`` for newly published ``v-<N>`` stage dirs and
    hot-swap the newest intact one into ``registry``.

    ``loader(path)`` turns a published dir into a servable (default:
    ``servable.api.load_servable``); ``warmup(servable)`` runs before the
    swap (the server wires its own ``warmup`` here). A failure of either
    never touches the serving model: the version goes into ``failed`` with
    its error, ``ml.serving.swap.failures`` rises, and the next older intact
    version is tried. ``on_swap(version, servable)`` runs after each swap.
    """

    def __init__(
        self,
        directory: str,
        registry: ModelRegistry,
        *,
        loader: Optional[Callable[[str], object]] = None,
        warmup: Optional[Callable[[object], None]] = None,
        interval_ms: Optional[float] = None,
        backoff_max_ms: Optional[float] = None,
        backoff_seed: int = 0,
        on_swap: Optional[Callable[[int, object], None]] = None,
    ):
        from flink_ml_tpu_torch.config import Options, config

        if loader is None:
            from flink_ml_tpu_torch.servable.api import load_servable

            loader = load_servable
        self.directory = directory
        self.registry = registry
        self.loader = loader
        self.warmup = warmup
        self.on_swap = on_swap
        self.interval_s = (
            float(interval_ms) if interval_ms is not None
            else config.get(Options.SERVING_POLL_INTERVAL_MS)
        ) / 1000.0
        self.backoff_max_s = (
            float(backoff_max_ms) if backoff_max_ms is not None
            else config.get(Options.SERVING_POLL_BACKOFF_MAX_MS)
        ) / 1000.0
        # Consecutive scan errors double the wait up to the cap, with jitter
        # so replicas polling one dead share fall out of step; one clean scan
        # resets it to the interval.
        self._rng = random.Random(backoff_seed)
        self._consecutive_errors = 0
        self._next_wait_s = self.interval_s
        #: version → the error it failed with; every access holds ``_lock``.
        self.failed: Dict[int, BaseException] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _record_failed(self, version: int, error: BaseException) -> None:
        with self._lock:
            self.failed[version] = error
        metrics.counter(self.registry.scope, MLMetrics.SERVING_SWAP_FAILURES)

    def known_failed(self, version: int) -> bool:
        with self._lock:
            return version in self.failed

    # -- scan-failure backoff --------------------------------------------------
    def _note_scan_ok(self) -> None:
        with self._lock:
            self._consecutive_errors = 0
            self._next_wait_s = self.interval_s

    def _note_scan_error(self) -> None:
        with self._lock:
            self._consecutive_errors += 1
            base = min(self.interval_s * (2.0 ** (self._consecutive_errors - 1)), self.backoff_max_s)
            # up to +50% jitter, still capped
            self._next_wait_s = min(base * (1.0 + 0.5 * self._rng.random()), self.backoff_max_s)

    def backoff_state(self) -> Dict[str, object]:
        """The poller's backoff posture."""
        with self._lock:
            return {
                "consecutive_errors": self._consecutive_errors,
                "next_wait_s": self._next_wait_s,
                "interval_s": self.interval_s,
                "backoff_max_s": self.backoff_max_s,
                "backing_off": self._consecutive_errors > 0,
            }

    # -- one scan -------------------------------------------------------------
    def poll_once(self) -> Optional[int]:
        """Advance to the newest intact published version newer than the
        serving one. Returns the swapped-in version, or None."""
        versions = scan_numbered_dirs(self.directory, VERSION_PREFIX, _METADATA_MARKER)
        serving = self.registry.version
        for version in reversed(versions):
            if serving is not None and version <= serving:
                break
            if self.known_failed(version):
                continue
            path = os.path.join(self.directory, f"{VERSION_PREFIX}{version}")
            try:
                servable = self.loader(path)
                if self.warmup is not None:
                    self.warmup(servable)
            except BaseException as e:  # noqa: BLE001 — any load error marks the version bad
                self._record_failed(version, e)
                continue  # fall back to the next older intact version
            self.registry.swap(version, servable)
            if self.on_swap is not None:
                self.on_swap(version, servable)
            return version
        return None

    # -- background thread ----------------------------------------------------
    def start(self) -> "ModelVersionPoller":
        if self._thread is not None:
            raise RuntimeError("poller already started")
        self._thread = threading.Thread(
            target=self._loop, name=f"model-version-poller[{self.directory}]", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                # A scan error must not kill the poller; ml.serving.poll.errors
                # shows it, and the cadence backs off.
                metrics.counter(self.registry.scope, MLMetrics.SERVING_POLL_ERRORS)
                self._note_scan_error()
            else:
                self._note_scan_ok()
            with self._lock:
                wait_s = self._next_wait_s
            self._stop.wait(wait_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
