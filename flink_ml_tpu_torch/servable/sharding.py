"""PlanSharding — the mesh placement of a compiled plan. Twin of
``flink_ml_tpu/servable/sharding.py``.

The chain compiler (``servable/planner.py``) and its two consumers — the
serving tier's ``CompiledServingPlan`` and the batch tier's
``CompiledBatchPlan`` — run on one device by default. With ``serving.mesh``
/ ``batch.mesh`` (the data axis) or ``serving.mesh.model`` /
``batch.mesh.model`` (the model axis) above 1 they run on a grid of
``n_data × n_model`` shards, and this module is where the plan tier meets it.

**One process, a grid of shards.** The JAX package runs one controller over
N devices and lets XLA's SPMD partitioner split each program. Its twin here
is one process driving the grid itself: a bucket's rows split into
``n_data`` row shards, one tensor each; every program of the chain runs once
per shard on that shard's rows, on that shard's device; the outputs are
concatenated into one tensor per column, so a batch is still read back once.
There is no ``torch.distributed`` world — a server has no process group —
and no ``parallel/mesh.py`` ``MeshContext``, which is a rank grid over one.

**Where shards go.** Shard ``i`` of the grid (data-major: ``i = data ·
n_model + model``) lives on ``cuda:((base + i) mod
torch.cuda.device_count())``, ``base`` the index of the plan's device, when
that device is CUDA — so shard 0 is on the device the caller asked for —
and on the CPU when it is the CPU. On one card
every shard shares it, and the shards time-share it: the gain across cards
cannot be measured on one. Each shard keeps the local shape of the mesh that
was asked for, so a mesh wider than the cards does not raise, as the JAX
package does (its reason — a silently shrunk mesh would serve at other local
shapes — does not hold here).

**Bit-equality per row.** A shard's rows must come out bit-equal to the
same rows computed inside the unsharded bucket. The JAX package gets that
from the row blocking of XLA CPU's gemv (8 rows: ``MIN_SHARD_ROWS``), and
keeps every sharded shape a multiple of it. The port keeps the same ladder
and the same padding rules, and its per-row bodies are row-stable at every
multiple of 8 by construction:

- elementwise math and a per-row softmax do not depend on the row count on
  either backend; cuBLAS's products and CUDA's row sums do, and so do ATen
  CPU's scalar tail of a transcendental and MKL's sub-16-row ``sgemm``
  path: the serving bodies take row-stable forms (``ops/rowstable.py``) —
  on the CPU always, on CUDA in a plan with more than one data shard, so
  mesh 1 and ``Model.transform`` keep cuBLAS;
- the fast tier's CUDA megakernels fold each row in an order fixed by its
  width alone, so a data-sharded segment launches the chain's megakernel
  once per shard, on that shard's rows. The program kind is chosen once
  per key, at the bucket's rows, so every shard and mesh 1 run the same
  kind.

So mesh N is bit-identical per row to mesh 1 in both fusion tiers — on
CUDA to the mesh-1 plan run inside ``rowstable.required()``, and within the
fast tier's ulp envelope of the default mesh-1 plan, which stays on cuBLAS.

- **Serving buckets** are multiples of ``MIN_SHARD_ROWS · n_data``
  (:meth:`PlanSharding.serving_buckets`).
- **Batch chunks** shard when their row count is a multiple of
  ``MIN_SHARD_ROWS``, padded up to a multiple of ``MIN_SHARD_ROWS ·
  n_data`` (pad rows repeat row 0 and are sliced off). Any other ragged
  tail runs **replicated**: once on each distinct device, at its natural
  shape, read back from the first.

**Tensor parallelism** (``n_model > 1``) splits the output dimension of
every 2-D model array at least :data:`TP_MIN_WIDTH` wide and divisible by
``n_model`` (:meth:`PlanSharding.put_model`), exactly where the JAX package
splits it; the bodies that read such an array have a hand-written split form
(``ops/tensor_parallel.py``). It carries an envelope (rtol 1e-5, atol 1e-6
of mesh 1) instead of bit-equality, and a tensor-parallel segment runs the
merged programs, as the JAX package does: no megakernel.

Model arrays are uploaded when the plan is built — for serving, at swap time,
before the version flip — once per distinct device: shards on one card share
one tensor. Rows arrive through :meth:`PlanSharding.put_batch`, one
host→device copy per shard.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops.tensor_parallel import ColumnShards
from flink_ml_tpu_torch.servable.planner import to_device

__all__ = [
    "MIN_SHARD_ROWS",
    "TP_MIN_WIDTH",
    "PlanSharding",
    "resolve_plan_sharding",
]

#: The sharded-shape quantum: every sharded bucket, chunk and local shard is
#: a multiple of it (the JAX package's, from XLA CPU's 8-row gemv blocking).
MIN_SHARD_ROWS = 8

#: Narrowest last dimension a 2-D model array must have before the model
#: axis splits it: narrower heads gain nothing from the split.
TP_MIN_WIDTH = 64


def _grid_devices(n: int, device: torch.device) -> Tuple[torch.device, ...]:
    if device.type == "cpu":
        return (device,) * n
    count = torch.cuda.device_count()
    base = device.index if device.index is not None else torch.cuda.current_device()
    return tuple(torch.device("cuda", (base + i) % count) for i in range(n))


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class PlanSharding:
    """The resolved placement of one compiled plan (module docstring): the
    shard grid's devices, the padding rules, and the upload entry points.

    ``devices`` is the plan's device (``None`` → the GPU, no card raises),
    whose shards follow the placement rule, or an explicit sequence of
    ``n_data · n_model`` devices in data-major order.
    """

    __slots__ = ("n_data", "n_model", "devices", "model_uploads")

    def __init__(self, n_data: int, n_model: int = 1,
                 devices: Optional[Union[str, torch.device, Sequence[Any]]] = None):
        self.n_data, self.n_model = int(n_data), int(n_model)
        if self.n_data < 1 or self.n_model < 1:
            raise ValueError(f"mesh axes must be >= 1, got {self.n_data}x{self.n_model}")
        n = self.n_data * self.n_model
        if devices is None or isinstance(devices, (str, torch.device)):
            self.devices = _grid_devices(n, resolve_device(devices))
        else:
            self.devices = tuple(resolve_device(d) for d in devices)
            if len(self.devices) != n:
                raise ValueError(f"mesh {self.n_data}x{self.n_model} needs {n} devices, got {len(self.devices)}")
        #: Host→device model-array copies made so far (a test's probe that
        #: the serving path uploads none).
        self.model_uploads = 0

    # -- identity --------------------------------------------------------------
    @property
    def key(self) -> Tuple[int, int]:
        """Cache identity of this placement: plans built under one key hold
        other shards, and other model tensors, than under another."""
        return (self.n_data, self.n_model)

    def __repr__(self) -> str:
        return (f"PlanSharding(data={self.n_data}, model={self.n_model}, "
                f"devices=[{', '.join(str(d) for d in self.devices)}])")

    def shard_device(self, data: int, model: int = 0) -> torch.device:
        """The device of grid shard ``(data, model)``."""
        return self.devices[data * self.n_model + model]

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """Each data shard's device (its first model shard's): where its
        rows are uploaded and its outputs are computed."""
        return tuple(self.shard_device(i) for i in range(self.n_data))

    def replica_shards(self) -> List[int]:
        """The data shards a replicated block runs on: the first of each
        distinct device."""
        first: Dict[torch.device, int] = {}
        for i, dev in enumerate(self.data_devices):
            first.setdefault(dev, i)
        return list(first.values())

    # -- padding discipline ----------------------------------------------------
    @property
    def row_multiple(self) -> int:
        """The quantum every sharded shape is a multiple of."""
        return MIN_SHARD_ROWS * self.n_data

    def padded_rows(self, n: int) -> int:
        """``n`` rounded up to :attr:`row_multiple`."""
        r = n % self.row_multiple
        return n if r == 0 else n + (self.row_multiple - r)

    def shardable_rows(self, n: int) -> bool:
        """Whether an ``n``-row block may shard (padded up to
        :attr:`row_multiple`): ``n`` is a multiple of ``MIN_SHARD_ROWS``."""
        return n % MIN_SHARD_ROWS == 0

    def serving_buckets(self, max_batch_size: int) -> Tuple[int, ...]:
        """The mesh bucket ladder: doubling sizes from ``MIN_SHARD_ROWS ·
        n_data`` up to ``max_batch_size``, itself always a bucket."""
        floor = self.row_multiple
        if max_batch_size < floor or max_batch_size % floor:
            raise ValueError(
                f"serving.mesh={self.n_data} needs serving.max.batch.size to be a "
                f"multiple of {floor} (= MIN_SHARD_ROWS * mesh, the sharded "
                f"bucket quantum); got {max_batch_size}"
            )
        buckets = []
        b = floor
        while b < max_batch_size:
            buckets.append(b)
            b *= 2
        buckets.append(max_batch_size)
        return tuple(buckets)

    # -- placement -------------------------------------------------------------
    def put_batch(self, array: np.ndarray) -> List[torch.Tensor]:
        """A host block's rows split into ``n_data`` equal shards, each on
        its data shard's device: one host→device copy per shard. Rows must
        be a multiple of ``n_data`` (the padding rules above)."""
        rows = array.shape[0]
        if rows % self.n_data:
            raise ValueError(f"{rows} rows do not split over the {self.n_data}-way data axis")
        m = rows // self.n_data
        return [to_device(array[i * m:(i + 1) * m], dev) for i, dev in enumerate(self.data_devices)]

    def put_replicated(self, array: np.ndarray) -> List[torch.Tensor]:
        """A whole host block on each device of :meth:`replica_shards`."""
        return [to_device(array, self.data_devices[i]) for i in self.replica_shards()]

    def put_columns(self, arrays: Dict[str, np.ndarray], replicated: bool = False) -> List[Dict[str, torch.Tensor]]:
        """A block's columns as one ``{name: tensor}`` per data shard
        (:meth:`put_batch`), or per replica (:meth:`put_replicated`): the
        planner's sharded calling convention."""
        put = self.put_replicated if replicated else self.put_batch
        parts = {name: put(arr) for name, arr in arrays.items()}
        n = len(self.replica_shards()) if replicated else self.n_data
        return [{name: p[i] for name, p in parts.items()} for i in range(n)]

    def put_model(self, array: np.ndarray) -> Tuple[Any, ...]:
        """One model array on the grid: one value per data shard. Uploaded
        once per distinct device (shards on one card share the tensor). With
        a model axis, a 2-D array at least :data:`TP_MIN_WIDTH` wide whose
        width divides by ``n_model`` splits its output (last) dimension into
        a :class:`~flink_ml_tpu_torch.ops.tensor_parallel.ColumnShards`,
        piece ``j`` on model shard ``j``'s device; any other array is
        replicated."""
        arr = np.asarray(array)
        split = (self.n_model > 1 and arr.ndim == 2 and arr.shape[1] >= TP_MIN_WIDTH
                 and arr.shape[1] % self.n_model == 0)
        pieces = np.split(arr, self.n_model, axis=1) if split else [arr]
        uploaded: Dict[Tuple[int, torch.device], torch.Tensor] = {}

        def on(piece: int, dev: torch.device) -> torch.Tensor:
            if (piece, dev) not in uploaded:
                uploaded[(piece, dev)] = _upload(pieces[piece], dev)
                self.model_uploads += 1
            return uploaded[(piece, dev)]

        if not split:
            return tuple(on(0, dev) for dev in self.data_devices)
        return tuple(
            ColumnShards(on(j, self.shard_device(i, j)) for j in range(self.n_model))
            for i in range(self.n_data)
        )


def resolve_plan_sharding(mesh: Optional[int], mesh_model: Optional[int] = 1,
                          device=None) -> Optional[PlanSharding]:
    """A plan tier's mesh config as a placement on ``device``'s shard grid,
    or ``None`` for the single-device path (``mesh`` and ``mesh_model``
    unset, 1 or fewer — the default)."""
    n_data = int(mesh) if mesh else 1
    n_model = int(mesh_model) if mesh_model else 1
    if n_data <= 1 and n_model <= 1:
        return None
    return PlanSharding(max(1, n_data), max(1, n_model), device)
