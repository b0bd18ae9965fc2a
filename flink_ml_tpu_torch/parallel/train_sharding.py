"""Training-side sharding — twin of ``flink_ml_tpu/parallel/train_sharding.py``.

``TrainSharding`` places a fit's state on the mesh (every rank holds the
model: SGD's coefficient, KMeans' centroids, the MLP's layers) and deals the
training rows so the deterministic mapreduce tier
(``parallel/collectives.py``) reduces them in an order that does not depend
on the width:

1. **Block-cyclic deal.** Rows are zero-padded to a multiple of the global
   batch B (itself a multiple of the quantum 8·N) and their 8-row blocks
   dealt round-robin: rank k holds global blocks k, k + N, k + 2N, … as one
   contiguous run, realised by one host permutation. A global window
   [s, s + B) with s and B multiples of 8·N is then the contiguous local
   window [s/N, s/N + B/N) on every rank, and every epoch consumes the same
   global rows at every width.
2. **Deterministic reduce.** ``collectives.mapreduce_sum``: the same blocks
   and the same fold at every width, so an epoch is bit-identical to the
   width-1 program.

Every rank is handed the whole input (as the JAX package's single
controller sees every row) and uploads only its own rows.

Tensor parallelism (``train.mesh.model`` > 1) adds a model axis: the fit
runs on ``n_data × n_model`` ranks, rank ``d·n_model + m`` holding data
shard d's rows and model shard m's slice of the coefficient; the
deterministic tier stays data-parallel, and TP fits run the psum paths
(``ops/optimizer.py``).

``resolve_train_sharding`` is the config-driven entry: an explicit
``train.mesh = 1`` resolves to a width-1 ``TrainSharding`` that runs the
deterministic program with no process group; unset or 0 keeps the
single-device paths. ``ensure_distributed`` makes the one
``init_process_group`` a run needs, from torchrun's environment.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.parallel.collectives import BLOCK_ROWS
from flink_ml_tpu_torch.parallel.mesh import MeshContext

__all__ = [
    "ShardedTrainCache",
    "TrainSharding",
    "ensure_distributed",
    "pick_backend",
    "resolve_train_sharding",
]

_distributed_lock = threading.Lock()


def pick_backend(world_size: int, device: Optional[Union[str, torch.device]] = None) -> str:
    """The transport of a world of ``world_size`` ranks on ``device``:
    gloo on the CPU; on CUDA, NCCL when every rank of the host can hold its
    own card (``LOCAL_WORLD_SIZE``, else the world, against
    ``torch.cuda.device_count()``), else gloo — NCCL refuses two ranks on one
    card. Decided up front, never by retrying after a failure."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def ensure_distributed(n_hosts: Optional[int] = None, backend: Optional[str] = None,
                       device: Optional[Union[str, torch.device]] = None) -> bool:
    """Initialise the default process group once, when the run asks for one.

    A group that already exists (a caller's own ``init_process_group``) is
    used as it is. Otherwise torchrun's environment (``WORLD_SIZE`` > 1, with
    ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or ``train.mesh.hosts`` > 1
    asks for one: ``init_process_group`` with ``backend`` (None →
    :func:`pick_backend`) from that environment. A single process with no such
    environment returns False and touches nothing."""
    if dist.is_available() and dist.is_initialized():
        return True
    if n_hosts is None:
        from flink_ml_tpu_torch.config import Options, config

        n_hosts = config.get(Options.TRAIN_MESH_HOSTS)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        if n_hosts and int(n_hosts) > 1:
            raise ValueError(
                f"train.mesh.hosts is {n_hosts} but this process has no world: start it "
                "through torchrun (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)"
            )
        return False
    backend = backend or pick_backend(world, device)
    rank = int(os.environ["RANK"])
    kw = {}
    if backend == "nccl":  # the rank's own card, named up front
        kw["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    with _distributed_lock:
        if not dist.is_initialized():
            dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank, **kw)
    return True


class TrainSharding:
    """Placement and deal discipline of one sharded fit over ``n_data`` ×
    ``n_model`` ranks (the train mesh is single-slice, as in JAX). The
    quanta and the deal are arithmetic on ``n_data``: the deal runs over
    the rank's data index, so the model shards of one data index hold the
    same rows. The rank's :class:`MeshContext` is made on first use of
    :attr:`ctx`, and raises there unless the process group has ``n_data ·
    n_model`` ranks."""

    def __init__(self, n_data: int = 1, n_model: int = 1,
                 device: Optional[Union[str, torch.device]] = None, ctx: Optional[MeshContext] = None):
        if n_data < 1 or n_model < 1:
            raise ValueError(f"train mesh axes must be >= 1, got {n_data}x{n_model}")
        if ctx is not None and (ctx.n_data, ctx.n_model) != (n_data, n_model):
            raise ValueError(
                f"a mesh context of {ctx.n_data}x{ctx.n_model} ranks cannot hold train.mesh {n_data}x{n_model}"
            )
        self.n_data = int(n_data)
        self.n_model = int(n_model)
        self._device = device
        self._ctx = ctx

    @property
    def ctx(self) -> MeshContext:
        if self._ctx is None:
            self._ctx = MeshContext(n_data=self.n_data, n_model=self.n_model, device=self._device)
        return self._ctx

    @property
    def key(self):
        return (self.n_data, self.n_model)

    # --- quanta --------------------------------------------------------------
    @property
    def row_quantum(self) -> int:
        """Rows per indivisible unit: one 8-row block per data shard."""
        return BLOCK_ROWS * self.n_data

    def round_batch(self, global_batch: int) -> int:
        """Smallest quantum multiple >= ``global_batch``."""
        q = self.row_quantum
        return max(q, ((int(global_batch) + q - 1) // q) * q)

    def padded_rows(self, n: int, global_batch: int) -> int:
        """The smallest multiple of ``global_batch`` >= n: a function of
        (n, B) alone, so every epoch's global window is the same at every
        width and never wraps or clamps."""
        b = int(global_batch)
        if b % self.row_quantum:
            raise ValueError(
                f"global batch {b} is not a multiple of the row quantum "
                f"{self.row_quantum} (use round_batch)"
            )
        return max(b, ((int(n) + b - 1) // b) * b)

    def deal_permutation(self, n_padded: int) -> np.ndarray:
        """Row permutation realising the block-cyclic deal as contiguous
        shards: global block g lands on shard g mod N at local position
        g // N."""
        if n_padded % self.row_quantum:
            raise ValueError(f"{n_padded} rows not a multiple of the quantum {self.row_quantum}")
        n_blocks = n_padded // BLOCK_ROWS
        order = np.arange(n_blocks).reshape(-1, self.n_data).T.reshape(-1)
        return (order[:, None] * BLOCK_ROWS + np.arange(BLOCK_ROWS)).reshape(-1)

    # --- placement -----------------------------------------------------------
    def replicate(self, array, dtype=None) -> torch.Tensor:
        """Replicated state: a copy on this rank's device."""
        return self.ctx.replicate(array, dtype)

    def place_state(self, tree):
        """Every array of a list/tuple tree of model state, replicated."""
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place_state(x) for x in tree)
        return self.replicate(tree)

    def deal_cache(self, columns: Dict[str, np.ndarray], global_batch: Optional[int] = None,
                   dtype=np.float32) -> "ShardedTrainCache":
        """Ingest host columns under the deal; ``global_batch`` defaults to
        one quantum and is rounded up to one."""
        b = self.round_batch(global_batch if global_batch else self.row_quantum)
        return ShardedTrainCache(columns, self, b, dtype=dtype)


class ShardedTrainCache:
    """The rank's share of a training set under the block-cyclic deal.

    The ranks of data index k upload rows ``[k·L, (k+1)·L)`` of the
    permuted, padded set (L = n_padded / N): padding rows carry zeros and a zero mask, so they add
    nothing to any fold. The surface of ``iteration.DeviceDataCache``
    (``cache[name]``, ``mask``, ``local_rows``, ``n_valid``). Bumps the
    ingest and padding counters of ``MLMetrics.TRAIN_GROUP`` by this fit's
    rows."""

    def __init__(self, columns: Dict[str, np.ndarray], sharding: TrainSharding,
                 global_batch: int, dtype=np.float32):
        self.sharding = sharding
        self.global_batch = int(global_batch)
        lengths = {np.asarray(c).shape[0] for c in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        self.n_valid = n
        self.n_padded = sharding.padded_rows(n, self.global_batch)
        L = self.n_padded // sharding.n_data
        ctx = sharding.ctx
        rows = sharding.deal_permutation(self.n_padded)[ctx.data_index * L:(ctx.data_index + 1) * L]
        valid = rows < n
        self.device = ctx.device
        self.arrays: Dict[str, torch.Tensor] = {}
        for name, col in columns.items():
            col = np.asarray(col)
            if col.dtype.kind == "f":
                col = col.astype(dtype, copy=False)
            local = np.zeros((L,) + col.shape[1:], col.dtype)
            local[valid] = col[rows[valid]]
            self.arrays[name] = torch.from_numpy(local).to(self.device)
        self.arrays["__mask__"] = torch.from_numpy(valid.astype(np.float32)).to(self.device)
        metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARD_INGEST_ROWS, n)
        metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARD_PAD_ROWS, self.n_padded - n)

    @property
    def local_rows(self) -> int:
        """Rows on this rank (padded; a multiple of the local batch)."""
        return self.n_padded // self.sharding.n_data

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.sharding.n_data

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    @property
    def mask(self) -> torch.Tensor:
        return self.arrays["__mask__"]


def resolve_train_sharding(device: Optional[Union[str, torch.device]] = None) -> Optional[TrainSharding]:
    """A TrainSharding iff ``train.mesh`` is set (an explicit 1 included);
    None when it is unset or 0. Makes the process group a torchrun launch
    asks for, and raises when ``train.mesh`` × ``train.mesh.model`` is
    not the world size — training narrower or wider than asked must not
    pass silently."""
    from flink_ml_tpu_torch.config import Options, config

    n_data = config.get(Options.TRAIN_MESH)
    if not n_data or int(n_data) < 1:
        return None
    n_model = config.get(Options.TRAIN_MESH_MODEL) or 1
    ensure_distributed(device=device)
    ts = TrainSharding(int(n_data), int(n_model), device=device)
    ts.ctx  # noqa: B018 — the world-size check, before any row is read
    return ts
