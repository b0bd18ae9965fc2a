"""Minibatch SGD on one device or a mesh of ranks — twin of
``flink_ml_tpu/ops/optimizer.py``.

Reference: ``SGD.java`` — per epoch the next ``globalBatchSize`` rows of the
cached data (``nextBatchOffset`` cycling), the feedback ``[gradSum,
weightSum, lossSum]``, the update ``coef -= lr/totalWeight · grad`` followed
by regularization, and ``TerminateOnMaxIterOrTol`` on loss/totalWeight.

The dataset lives on the device (``DeviceDataCache``) and epochs run in
fused chunks, as in the JAX package: the host computes the whole minibatch
schedule up front, launches a chunk of epochs without reading anything
back, and carries the termination flag ``done``, the executed-epoch count
and the per-epoch losses on the device (``torch.where`` freezes the
coefficient once ``done``). The host reads them once per chunk
(``fused_chunk_len`` bounds the chunk), so no epoch waits for the device.

Three epoch forms:

- dense features: ``X @ coef`` and ``X.T @ mult`` (two matrix products);
- sparse padded CSR, scatter path: gather dot and ``index_add_`` gradient;
- sparse, one-hot path (wide coefficients): the class-major layout of
  ``linalg/onehot_sparse.py`` and its four hand-written CUDA crossings —
  the premat pair when the materialised one-hots fit the device's memory
  budget (``onehot_premat``), else the build-form pair.

A fit with a checkpoint manager, a checkpoint interval or listeners runs
the host loop instead (``_optimize_host_loop``): one epoch a turn of the
bounded iteration loop (``iteration/iteration.py``) over the dense or
scatter-sparse epoch, the variables ``[coef, offset]`` snapshotted between
epochs, as the JAX package's host loop does. It never takes the one-hot
path (JAX ``optimizer.py:1065-1069``), and ``sparse_kernel='onehot'`` with
any of the three raises. Resumed or not, it runs the fused path's epoch
function on the same slices: on the CPU its coefficient is bit-equal to the
fused fit's, and on the card the dense step's is (the scatter step's
``index_add_`` sums by atomics there).

On a mesh (``train.mesh``, an explicit ``sharding`` or ``ctx``; JAX
``optimize`` :972-1016) every rank is handed the whole input, uploads only
its own rows and returns the same coefficient:

- a dense fused fit with a ``TrainSharding`` runs the deterministic tier
  (``_optimize_deterministic``): the rows dealt block-cyclically, per-row
  ``[mult·x | w | loss]`` folded through ``collectives.mapreduce_sum``, the
  margin summed by ``row_fold_sum`` — bit-identical at every width;
- every other fit (sparse scatter and one-hot, the host loop with a
  checkpoint manager or listeners, a ``ctx`` mesh) runs the psum paths: each
  rank takes ``ceil(B / N)`` rows of its contiguous share per epoch and
  all-reduces the packed ``[grad | weight | loss]``. Their global minibatch
  changes with the width, as in the JAX package, so they are held to the
  JAX package at the same width. The one-hot layout's plan is counted over
  every rank's rows, so every rank permutes the gradient alike.

Tensor parallelism (``train.mesh.model`` > 1, or a ``ctx`` with a model
axis; JAX :160-205, :394-470, :502-616) shards the coefficient over the
model axis on all three paths, fused and in the host loop: sparse scatter
gathers and scatters each rank's index range, dense takes the rank's column
slice of the features (padded to a multiple of ``n_model``), and one-hot
runs the plan's model shard of the stacks at its local block count. Each
path all-reduces the partial margins over the model axis before the loss,
keeps the gradient local, and returns the whole coefficient on every rank.

Streamed fits (JAX ``_optimize_streaming`` :1651, ``_optimize_streaming_onehot``
:1457): ``optimize`` on a host-tier cache (``HostDataCache``,
``NativeDataCache``, larger than the card) streams per-shard windows of
``stream_window_rows`` rows (``train.stream.window.rows``) onto the device
through ``iteration/streaming.py``'s ``run_windows``: every epoch whose
minibatch lies in the resident window runs in one run of launches while the
next window is read, pinned and copied. The dense and scatter paths run the
resident epoch on the window (``_sgd_epoch_math``); sparse fits take the
one-hot path under the resident rule's feasibility (``_pick_onehot_streamed``),
whose one counting pass over the cache (``streamed_onehot_plan``) sizes one
``OneHotSparsePlan`` for every window, each window's stacks filled on the
host against it (``_OneHotWindowStream``) and its ``row_order`` (build form)
or row one-hots (premat, ``_premat_streamed``) made on the device when it
lands. A window's minibatches play the resident layout's windows, so the
epoch is ``onehot_batch_step`` as in ``_optimize_onehot``. Checkpoints are
taken at run boundaries (``{next_run, coef, done, loss_history}``, the
logical coefficient), listeners are refused. On a mesh every rank loads only
its data shard's rows of each window and, one-hot, fills only its model
index's stacks; sparse fits shard the coefficient over the model axis, dense
ones keep it whole.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
from flink_ml_tpu_torch.iteration.streaming import WindowedStream, is_host_cache
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.ops.lossfunc import LossFunc
from flink_ml_tpu_torch.ops.schedule import chunked_schedule, offset_schedule
from flink_ml_tpu_torch.parallel.collectives import (
    all_reduce_packed,
    all_reduce_tensor,
    mapreduce_sum,
    row_fold_sum,
    rowwise,
)
from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding

__all__ = ["Optimizer", "SGD", "fused_chunk_len", "regularize", "streamed_onehot_plan"]


def regularize(coef, reg: float, elastic_net: float, learning_rate: float):
    """Prox-style regularization update; returns (new_coef, reg_loss).
    The three branches of RegularizationUtils.regularize (L2, L1, elastic net)."""
    if reg == 0.0:
        return coef, torch.zeros((), dtype=coef.dtype, device=coef.device)
    if elastic_net == 0.0:  # pure L2
        return coef * (1.0 - learning_rate * reg), reg / 2.0 * torch.sum(coef * coef)
    if elastic_net == 1.0:  # pure L1
        return coef - learning_rate * reg * torch.sign(coef), reg * torch.sum(torch.abs(coef))
    l1 = elastic_net * reg
    l2 = (1.0 - elastic_net) * reg
    loss = l1 * torch.sum(torch.abs(coef)) + l2 / 2.0 * torch.sum(coef * coef)
    update = learning_rate * (l1 * torch.sign(coef) + l2 * coef)
    return coef - update, loss


def _gather_model(local: torch.Tensor, ctx) -> torch.Tensor:
    """The whole ``[n_model · |local|]`` vector of every model shard's
    ``local`` slice, on every rank of the model axis: the slice placed in
    zeros and all-reduced, so every entry is one shard's value plus exact
    zeros."""
    full = local.new_zeros((ctx.n_model,) + tuple(local.shape))
    full[ctx.model_index] = local
    return all_reduce_tensor(full, ctx, "model").reshape(-1)


class _ModelShardedSnapshots:
    """A ``ShardedCheckpointManager`` seen by a tensor-parallel host loop:
    ``save`` writes the rank's coefficient slice as a piece of the padded
    ``[d_pad]`` coefficient (the JAX model-sharded leaf, deduplicated over
    the data axis by placement), ``restore_latest`` hands the rank its slice
    of the reassembled coefficient back. Everything else is the manager's."""

    def __init__(self, mgr, ctx, dim: int):
        self._mgr = mgr
        self._lo, self._hi, self._d_pad = ctx.model_range(dim)

    def __getattr__(self, name):
        return getattr(self._mgr, name)

    def save(self, step: int, variables):
        from flink_ml_tpu_torch.checkpoint import ShardedLeaf

        coef, *rest = variables
        return self._mgr.save(step, [ShardedLeaf((self._d_pad,), [(((self._lo, self._hi),), coef)]), *rest])

    def restore_latest(self, device=None):
        got = self._mgr.restore_latest(device=device)
        if got is None:
            return None
        step, (coef, *rest) = got
        coef = torch.as_tensor(np.asarray(coef.cpu() if isinstance(coef, torch.Tensor) else coef))
        coef = coef[self._lo:self._hi].contiguous()
        return step, [coef if device is None else coef.to(device), *rest]


class Optimizer:
    """optimize(initModel, trainData, lossFunc) — Optimizer.java."""

    def optimize(self, init_model, train_data, loss_func: LossFunc) -> np.ndarray:
        raise NotImplementedError


def _apply_update(coef, grad, weight_sum, loss_sum, lr, reg, elastic_net):
    """The update every epoch form shares: ``(new_coef, mean_loss)``."""
    safe_w = torch.clamp(weight_sum, min=1e-30)
    new_coef = torch.where(weight_sum > 0, coef - (lr / safe_w) * grad, coef)
    new_coef, _reg_loss = regularize(new_coef, reg, elastic_net, lr)
    # The criteria reads the un-regularized batch loss mean (SGD.java:137-143).
    mean_loss = torch.where(weight_sum > 0, loss_sum / safe_w, torch.full_like(loss_sum, np.inf))
    return new_coef, mean_loss


def _batch_rows(y, w, mask, start: int, offset: int, local_batch: int):
    """``(yb, wb)`` of the window at ``start``: rows before ``offset`` in a
    tail-clamped window are re-reads and weigh 0 (SGD.java:265-268)."""
    rows = slice(start, start + local_batch)
    tail_valid = (start + torch.arange(local_batch, device=y.device) >= offset).to(w.dtype)
    return y[rows], w[rows] * mask[rows] * tail_valid


def _sgd_partials(coef, start: int, offset: int, feats, y, w, mask, loss_func, local_batch: int, ctx=None):
    """A rank's ``(grad, weight_sum, loss_sum)`` of one dense or
    scatter-path sparse epoch. ``feats`` is a dense [m, d] tensor or a
    padded-CSR ``(indices [m, K], values [m, K])`` pair.

    ``coef`` is the rank's slice of the coefficient on ``ctx``'s model axis
    (JAX :160-205): dense, ``feats`` is the matching column slice; sparse,
    the rank gathers and scatters only its index range ``[lo, lo +
    |coef|)``. The partial margins are all-reduced over the model axis, so
    the multiplier is the same on every model shard and the gradient slice
    is local. With one model shard (or no ``ctx``) the range is the whole
    coefficient and the all-reduce returns its input."""
    yb, wb = _batch_rows(y, w, mask, start, offset, local_batch)
    if isinstance(feats, tuple):
        # Padding slots (index 0, value 0), another shard's indices and
        # zero-weight rows add 0.
        vb = feats[1][start:start + local_batch]
        local_d = coef.shape[0]
        ib = feats[0][start:start + local_batch].long() - (0 if ctx is None else ctx.model_index) * local_d
        in_range = (ib >= 0) & (ib < local_d)
        ib = torch.where(in_range, ib, 0).reshape(-1)
        vb = torch.where(in_range, vb, 0.0)
        dot = all_reduce_tensor(torch.sum(vb * coef[ib].reshape(vb.shape), dim=1), ctx, "model")
        loss_sum, mult = loss_func.loss_and_mult(dot, yb, wb)
        grad = torch.zeros_like(coef).index_add_(0, ib, (vb * mult[:, None]).reshape(-1))
    else:
        Xb = feats[start:start + local_batch]
        loss_sum, mult = loss_func.loss_and_mult(all_reduce_tensor(Xb @ coef, ctx, "model"), yb, wb)
        grad = Xb.T @ mult
    return grad, torch.sum(wb), loss_sum


def _sgd_epoch_math(coef, start: int, offset: int, feats, y, w, mask, loss_func,
                    local_batch: int, lr: float, reg: float, elastic_net: float, ctx=None):
    """One epoch of dense or scatter-path sparse SGD, the packed ``[grad |
    weight | loss]`` all-reduced over ``ctx``'s data axes (JAX
    ``optimizer.py:259-268``); ``coef`` is the rank's model slice
    (``_sgd_partials``). Returns ``(new_coef, mean_loss)``."""
    grad, wsum, loss_sum = all_reduce_packed(
        _sgd_partials(coef, start, offset, feats, y, w, mask, loss_func, local_batch, ctx), ctx
    )
    return _apply_update(coef, grad, wsum, loss_sum, lr, reg, elastic_net)


def _deterministic_epoch_math(coef, start: int, X, y, w, mask, loss_func, local_batch: int,
                              lr: float, reg: float, elastic_net: float, ctx=None):
    """One epoch of the deterministic tier (JAX ``_sgd_epoch_math``'s
    ``deterministic`` branch, :205-221): per-row ``[mult·x | w | loss]``
    reduced by ``mapreduce_sum``'s block/tree fold, the margin by
    ``row_fold_sum`` and the loss by ``rowwise`` — every sum in an order set
    by the global batch and d, and every row's arithmetic the same, whatever
    the local batch. The window never clamps (start == offset)."""
    Xb = X[start:start + local_batch]
    yb, wb = _batch_rows(y, w, mask, start, start, local_batch)
    row_loss, mult = rowwise(loss_func.row_loss_and_mult, row_fold_sum(Xb * coef), yb, wb)
    packed = mapreduce_sum(torch.cat([mult[:, None] * Xb, wb[:, None], row_loss[:, None]], dim=1), ctx)
    return _apply_update(coef, packed[:-2], packed[-2], packed[-1], lr, reg, elastic_net)


_TOL_CHUNK = 64  # epochs per readback when a tol criteria is active
_MAX_CHUNK_DENSE = 4096
_SERIAL_BUDGET = 300_000_000
_FLOP_BUDGET = 5e14


def fused_chunk_len(max_iter: int, check_loss: bool, serial_elems_per_epoch: int = 0,
                    flops_per_epoch: float = 0.0) -> int:
    """Epochs per chunk (the JAX package's policy, kept so both packages
    read back at the same epochs): tol runs read back every ``_TOL_CHUNK``
    epochs, so early convergence wastes at most a chunk; otherwise the
    chunk is capped by the epoch's gather/scatter elements and its
    matrix-product FLOPs."""
    cap = _MAX_CHUNK_DENSE
    if serial_elems_per_epoch > 0:
        cap = min(cap, max(1, _SERIAL_BUDGET // int(serial_elems_per_epoch)))
    if flops_per_epoch > 0:
        cap = min(cap, max(1, int(_FLOP_BUDGET / flops_per_epoch)))
    if check_loss:
        cap = min(cap, _TOL_CHUNK)
    return max(1, min(max_iter, cap))


def _launch_chunk(coef, done, starts_c, offsets_c, active_c, epoch: Callable, tol):
    """Queue one chunk's epochs without reading anything back: the
    coefficient frozen once ``done`` (``tol`` given: loss < tol; NaN
    continues), each executed epoch's mean loss recorded (inf after done).
    Returns ``(coef, done, (recorded, executed_n))``, all on the device."""
    recorded, executed_n = [], torch.zeros((), dtype=coef.dtype, device=coef.device)
    for start, offset, act in zip(starts_c, offsets_c, active_c):
        if not act:  # padding epochs of the last chunk: no-ops
            continue
        new_coef, mean_loss = epoch(coef, int(start), int(offset))
        executed = ~done
        coef = torch.where(executed, new_coef, coef)
        recorded.append(torch.where(executed, mean_loss, torch.full_like(mean_loss, np.inf)))
        executed_n = executed_n + executed.to(coef.dtype)
        if tol is not None:
            done = done | (executed & (mean_loss < tol))
    return coef, done, (recorded, executed_n)


def _read_losses(pending) -> List[float]:
    """The executed epochs' losses of a ``_launch_chunk`` (one readback)."""
    recorded, executed_n = pending
    host = torch.cat([torch.stack(recorded).to(executed_n.dtype), executed_n[None]]).cpu().numpy()
    return [float(x) for x in host[: int(host[-1])]]


def _host_ram_bytes() -> int:
    """MemTotal from /proc/meminfo, or 0 when unreadable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def _hbm_bytes_limit(device: torch.device) -> int:
    """Memory budget of ``device``: the card's total memory, or for the
    CPU the host's RAM capped at 16 GiB (the JAX package's stand-in)."""
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total)
    ram = _host_ram_bytes()
    return min(16 << 30, ram) if ram else 16 << 30


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def streamed_onehot_plan(cache, n_rows: int, n_data: int, window: int, local_batch: int, dim: int,
                         n_model: int = 1):
    """One counting pass over a host-tier cache → the ``OneHotSparsePlan``
    of every (shard, window, minibatch, sub-batch) unit of a streamed run
    (JAX :630). ``window`` is the batch-aligned width of the matching
    ``WindowSchedule``. Reads the cache once, a minibatch at a time; every
    rank counts every shard, so all derive the same plan."""
    from flink_ml_tpu_torch.linalg.onehot_sparse import (
        BLOCK,
        SUB_ROWS,
        OneHotSparsePlan,
        block_counts,
        validate_indices,
    )

    m = -(-n_rows // n_data)
    b = local_batch
    sub = min(SUB_ROWS, b)
    nblk = -(-dim // BLOCK)
    max_count = np.zeros(nblk, np.int64)
    for k in range(n_data):
        lo_s = k * m
        hi_s = min(lo_s + m, n_rows)
        for w0 in range(0, m, window):
            for b0 in range(w0, min(w0 + window, m), b):
                r0 = lo_s + b0
                r1 = min(lo_s + b0 + b, hi_s)
                if r1 <= r0:
                    continue
                got = cache.rows(r0, r1)
                idx_mb = np.asarray(got["indices"], np.int64)
                val_mb = np.asarray(got["values"])
                validate_indices(idx_mb, dim)
                for s0 in range(0, r1 - r0, sub):
                    np.maximum(max_count, block_counts(idx_mb[s0:s0 + sub], val_mb[s0:s0 + sub], nblk),
                               out=max_count)
    return OneHotSparsePlan.from_max_counts(max_count, dim, sub, n_model)


class _OneHotWindowStream(WindowedStream):
    """The one-hot path's window loader (JAX :718): a ``WindowedStream`` of
    the window's labels, weights and mask that also fills each minibatch's
    sub-batch units into this model shard's plan-conformant stacks ``[n_mb,
    n_sub, n_flat]`` on the host (``host_extra``) and, on the device as the
    window lands, builds what the crossings walk: the row one-hots
    (``premat``) or the build form's ``row_order`` (``on_device``). Nothing
    but the 7-byte slots and the row columns crosses the host link."""

    def __init__(self, cache, ctx, plan, window: int, local_batch: int, n_sub: int, premat: bool, device):
        super().__init__(cache, {"labels": "labels", "weights": "weights"}, ctx, window, device=device)
        self.plan = plan
        self.local_batch = int(local_batch)
        self.n_sub = int(n_sub)
        self.premat = bool(premat)

    def host_extra(self, rows):
        plan, b = self.plan, self.local_batch
        mi = 0 if self.ctx is None else self.ctx.model_index
        n_mb = -(-min(self.window, self.m) // b)
        shape = (n_mb, self.n_sub, plan.n_flat)
        host = {"lidx": np.zeros(shape, np.int8), "rowid": np.zeros(shape, np.int16),
                "lvals": np.zeros(shape, np.float32)}
        if rows is None:
            return host
        idx_w, val_w = np.asarray(rows["indices"]), np.asarray(rows["values"])
        n, sub = len(idx_w), plan.sub_batch
        for mb in range(min(n_mb, -(-n // b))):
            r0, r1 = mb * b, min(mb * b + b, n)
            for bi in range(self.n_sub):  # filled in place: no staging copy a unit
                s0 = r0 + bi * sub
                if s0 >= r1:
                    break
                s1 = min(s0 + sub, r1)
                plan.fill_unit(idx_w[s0:s1], val_w[s0:s1], host["lidx"][mb, bi], host["rowid"][mb, bi],
                               host["lvals"][mb, bi], mi)
        return host

    def on_device(self, win):
        from flink_ml_tpu_torch.linalg.onehot_sparse import premat_row_onehots, row_order

        if self.premat:
            return {"oh": premat_row_onehots(win["rowid"], self.plan.row_hi)}
        return {"order": row_order(win["rowid"], self.plan.row_hi, live=win["lvals"] != 0)}


class SGD(Optimizer):
    """Minibatch SGD on one device (``device`` None → the GPU) or a mesh.

    ``sharding``: a ``TrainSharding`` (the deterministic tier for dense
    fused fits); ``ctx``: a ``MeshContext`` (the psum paths). Neither given,
    ``train.mesh`` decides per fit; one of them, not both."""

    def __init__(
        self,
        max_iter: int = 20,
        learning_rate: float = 0.1,
        global_batch_size: int = 32,
        tol: float = 1e-6,
        reg: float = 0.0,
        elastic_net: float = 0.0,
        dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        listeners=(),
        sparse_kernel: str = "auto",
        onehot_premat: str = "auto",
        ctx=None,
        sharding=None,
        stream_window_rows: Optional[int] = None,
    ):
        if sharding is not None and ctx is not None:
            raise ValueError("pass ctx or sharding, not both")
        if sparse_kernel not in ("auto", "onehot", "scatter"):
            raise ValueError(
                f"sparse_kernel must be 'auto', 'onehot' or 'scatter', got {sparse_kernel!r}"
            )
        if onehot_premat not in ("auto", "on", "off"):
            raise ValueError(
                f"onehot_premat must be 'auto', 'on' or 'off', got {onehot_premat!r}"
            )
        if dtype not in _NP_DTYPES:
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.sparse_kernel = sparse_kernel
        self.onehot_premat = onehot_premat
        self.onehot_premat_active = False  # set per fit
        self.layout_seconds = 0.0  # host seconds spent building the one-hot layout, per fit
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.global_batch_size = global_batch_size
        self.tol = tol
        self.reg = reg
        self.elastic_net = elastic_net
        self.dtype = dtype
        self.device = device
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_interval = checkpoint_interval
        self.listeners = list(listeners)
        self.ctx = ctx
        self.sharding = sharding
        if stream_window_rows is None:  # the config tier decides
            from flink_ml_tpu_torch.config import Options, config

            stream_window_rows = config.get(Options.TRAIN_STREAM_WINDOW_ROWS)
        self.stream_window_rows = stream_window_rows
        self.loss_history: List[float] = []
        #: a streamed fit's readings: host seconds of the counting pass and
        #: of each window load and its parts (``WindowedStream.parts``), device
        #: ms of each run (CUDA events; empty on the CPU), wall seconds of the
        #: window loop
        self.stream_stats: dict = {}

    def _run_fingerprint(self, loss_func, rows: int, dim: int, n_data: int = 1, n_model: int = 1,
                         extra=None) -> str:
        """Run/config identity recorded with checkpoints: a different job
        pointed at the same directory fails loudly instead of resuming stale
        state. The JAX package's string for the same fit on ``n_data``
        shards; ``extra`` adds the streamed paths' keys (JAX :866-890)."""
        import hashlib
        import json

        sig = {
            "loss": type(loss_func).__name__,
            "max_iter": self.max_iter,
            "lr": self.learning_rate,
            "batch": self.global_batch_size,
            "tol": self.tol,
            "reg": self.reg,
            "elastic_net": self.elastic_net,
            "rows": rows,
            "dim": dim,
            "n_data": n_data,
            "n_model": n_model,
        }
        sig.update(extra or {})
        return hashlib.sha256(json.dumps(sig, sort_keys=True).encode()).hexdigest()[:16]

    def optimize(
        self,
        init_model: np.ndarray,
        train_data: Union[DeviceDataCache, Mapping[str, np.ndarray]],
        loss_func: LossFunc,
    ) -> np.ndarray:
        """Train and return the final coefficient (host array).

        ``train_data``: a DeviceDataCache or a dict of host columns with
        ``labels`` [n], optional ``weights`` [n], and either dense
        ``features`` [n, d] or padded-CSR ``indices``/``values`` [n, K]."""
        ts = self.sharding
        if ts is None and self.ctx is None:
            ts = resolve_train_sharding(self.device)
        ctx = self.ctx or (ts.ctx if ts is not None else None)
        self.onehot_premat_active = False
        self.layout_seconds = 0.0
        if is_host_cache(train_data):
            return self._optimize_streaming(init_model, train_data, loss_func, ctx)
        fused = self.checkpoint_manager is None and not self.checkpoint_interval and not self.listeners
        if isinstance(train_data, Mapping):
            cols = dict(train_data)
            if "indices" not in cols and self.sparse_kernel == "onehot":
                raise ValueError(
                    "sparse_kernel='onehot' applies to sparse (indices/values) "
                    "training data; this fit has dense features"
                )
            if "weights" not in cols:
                cols["weights"] = np.ones(np.asarray(cols["labels"]).shape[0])
            if ts is not None and ts.n_model == 1 and "features" in cols and fused:
                # The deterministic tier: dense fused data-parallel fits
                # ingest under the block-cyclic deal and reduce
                # width-invariantly. Sparse, TP and checkpointed/listener
                # fits run the psum paths below on the same mesh.
                return self._optimize_deterministic(init_model, cols, loss_func, ts)
            np_dtype = _NP_DTYPES[self.dtype]
            # On a TP mesh dense features ingest in their training layout,
            # the rank's column slice (JAX :1007-1016)
            specs = ({"features": ("data", "model")}
                     if "features" in cols and ctx is not None and ctx.n_model > 1 else None)
            train_data = DeviceDataCache(
                {k: np.asarray(v, np.int32 if k == "indices" else np_dtype) for k, v in cols.items()},
                device=None if ctx is not None else resolve_device(self.device), ctx=ctx,
                column_specs=specs,
            )
        elif not isinstance(train_data, DeviceDataCache):
            raise TypeError(
                f"train_data must be a DeviceDataCache, a host-tier cache or a dict of columns, "
                f"got {type(train_data).__name__}"
            )
        else:
            ctx = train_data.ctx  # the cache's layout decides the mesh
        sparse = "indices" in train_data.arrays
        if not sparse and self.sparse_kernel == "onehot":
            raise ValueError(
                "sparse_kernel='onehot' applies to sparse (indices/values) "
                "training data; this fit has dense features"
            )
        dim = int(np.asarray(init_model).shape[0])
        n_data = train_data.n_data
        model_sharded = ctx is not None and ctx.n_model > 1
        local_batch = min(-(-self.global_batch_size // n_data), train_data.local_rows)
        check_loss = bool(np.isfinite(self.tol) and self.tol > 0)

        if not fused and sparse and self.sparse_kernel == "onehot":
            raise ValueError(
                "sparse_kernel='onehot' runs only on the fused path; remove "
                "checkpoint managers/listeners or use 'auto'"
            )
        if fused and self._pick_onehot(sparse, train_data, local_batch, dim):
            result = self._optimize_onehot(init_model, train_data, loss_func, local_batch, check_loss, dim)
            if result is not None:
                return result
            # auto: the layout would not fit the memory budget — scatter instead

        y, w = train_data["labels"], train_data["weights"]
        mask = train_data.mask.to(self.dtype)
        if sparse:
            feats = (train_data["indices"], train_data["values"])
            serial = 2 * local_batch * int(feats[0].shape[-1])  # gather + scatter
        else:
            feats, serial = train_data["features"], 0
            if model_sharded:
                feats = self._tp_features(train_data, ctx)
        lr, reg, en = self.learning_rate, self.reg, self.elastic_net

        def epoch(coef, start, offset):
            return _sgd_epoch_math(coef, start, offset, feats, y, w, mask, loss_func,
                                   local_batch, lr, reg, en, ctx)

        coef = self._place_coef(ctx, init_model, train_data.device, model_sharded)
        if not fused:
            coef = self._optimize_host_loop(coef, train_data, loss_func, local_batch, check_loss, epoch,
                                            dim, model_sharded)
        else:
            starts, offsets = offset_schedule(train_data.local_rows, local_batch, self.max_iter)
            coef = self._run_chunks(
                coef, starts, offsets, fused_chunk_len(self.max_iter, check_loss, serial), check_loss, epoch,
            )
        if model_sharded:
            coef = _gather_model(coef, ctx)
        return coef.cpu().numpy()[:dim]

    @staticmethod
    def _tp_features(train_data, ctx) -> torch.Tensor:
        """The rank's column slice of the dense features, padded to a
        multiple of ``n_model`` (JAX :896-910): the cache's own column when
        it ingested the features so, else a slice made for this fit and not
        kept (it dies with the fit)."""
        X = train_data["features"]
        if "features" in train_data.model_sharded:
            return X
        c0, c1, d_pad = ctx.model_range(int(X.shape[1]))
        if d_pad > X.shape[1]:
            X = F.pad(X, (0, d_pad - int(X.shape[1])))
        return X[:, c0:c1].contiguous()

    def _place_coef(self, ctx, host_coef, device, model_sharded: bool) -> torch.Tensor:
        """The coefficient on ``device``: whole, or this rank's slice of it
        padded to a multiple of ``n_model`` (JAX :912-925)."""
        host_coef = np.asarray(host_coef, _NP_DTYPES[self.dtype])
        if model_sharded:
            c0, c1, d_pad = ctx.model_range(host_coef.shape[0])
            host_coef = np.concatenate([host_coef, np.zeros(d_pad - host_coef.shape[0], host_coef.dtype)])[c0:c1]
        return torch.as_tensor(host_coef, device=device)

    def _optimize_deterministic(self, init_model, cols, loss_func, ts) -> np.ndarray:
        """Dense fused SGD on the deterministic tier (JAX :1132).

        The rows ingest once under the block-cyclic deal and every epoch
        reduces through ``mapreduce_sum``: for a rounded global batch B the
        fit is bit-identical at every width (the batch rounds up to the
        quantum 8·N; pick B a multiple of 8·N_max to compare widths). Epoch e
        consumes the global window [e·B mod n', +B) of the padded set, which
        the deal makes the contiguous local window [start / N, +B / N) on
        every rank."""
        n = int(np.asarray(cols["labels"]).shape[0])
        B = ts.round_batch(min(self.global_batch_size, max(n, 1)))
        np_dtype = _NP_DTYPES[self.dtype]
        cache = ts.deal_cache({k: np.asarray(v, np_dtype) for k, v in cols.items()},
                              global_batch=B, dtype=np_dtype)
        local_batch = cache.local_batch
        check_loss = bool(np.isfinite(self.tol) and self.tol > 0)
        X, y, w = cache["features"], cache["labels"], cache["weights"]
        mask = cache.mask.to(self.dtype)
        lr, reg, en, ctx = self.learning_rate, self.reg, self.elastic_net, ts.ctx

        def epoch(coef, start, _offset):
            return _deterministic_epoch_math(coef, start, X, y, w, mask, loss_func, local_batch,
                                             lr, reg, en, ctx)

        # n' is a multiple of B, so the window never wraps or clamps
        starts = ((np.arange(self.max_iter, dtype=np.int64) * B) % cache.n_padded // ts.n_data).astype(np.int32)
        coef = ts.replicate(np.asarray(init_model, np_dtype))
        coef = self._run_chunks(coef, starts, starts, fused_chunk_len(self.max_iter, check_loss),
                                check_loss, epoch)
        metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        return coef.cpu().numpy()

    def _optimize_host_loop(self, coef, train_data, loss_func, local_batch: int,
                            check_loss: bool, epoch: Callable, dim: int,
                            model_sharded: bool = False) -> torch.Tensor:
        """One epoch a turn of the bounded iteration loop, with the
        manager's snapshots and the listeners (JAX ``optimizer.py:1599``).
        The variables are ``[coef, offset]``: the offset is a host int32
        scalar, so the slice start never waits for the device. ``loss_history``
        holds a float an epoch when tol is on, else the device scalars read
        once at the end. Under tensor parallelism ``coef`` is the rank's
        model slice, snapshotted as a model-sharded leaf of the padded
        coefficient (``_ModelShardedSnapshots``). Returns the final
        coefficient tensor."""
        from flink_ml_tpu_torch.iteration import (
            IterationBodyResult,
            IterationConfig,
            TerminateOnMaxIterOrTol,
            iterate_bounded_until_termination,
        )

        mgr = self.checkpoint_manager
        ctx = train_data.ctx
        ranks = 1 if ctx is None else ctx.n_data * ctx.n_model
        if mgr is not None and ranks > 1 and not isinstance(mgr, ShardedCheckpointManager):
            raise ValueError(
                "a checkpointed fit on a mesh of several ranks needs a ShardedCheckpointManager "
                "(rank 0 writes, the others wait); a CheckpointManager would be written by every rank"
            )
        if mgr is not None:
            mgr.set_fingerprint(
                self._run_fingerprint(loss_func, int(train_data.n_valid), dim, train_data.n_data,
                                      1 if ctx is None else ctx.n_model)
            )
            if model_sharded:
                mgr = _ModelShardedSnapshots(mgr, ctx, dim)
        m = train_data.local_rows
        criteria = TerminateOnMaxIterOrTol(self.max_iter, self.tol)
        self.loss_history = []

        def body(variables, ep):
            cur_coef, cur_offset = variables
            offset = int(cur_offset)
            new_coef, mean_loss = epoch(cur_coef, min(offset, m - local_batch), offset)
            next_offset = np.asarray(0 if offset + local_batch >= m else offset + local_batch, np.int32)
            if check_loss:  # the criteria needs the value now
                self.loss_history.append(float(mean_loss))
                cont = criteria(ep, self.loss_history[-1])
            else:
                self.loss_history.append(mean_loss)
                cont = criteria(ep, None)
            return IterationBodyResult([new_coef, next_offset], outputs=[new_coef],
                                       termination_criteria=cont)

        config = IterationConfig(checkpoint_manager=mgr, checkpoint_interval=self.checkpoint_interval)
        outputs = iterate_bounded_until_termination(
            [coef, np.asarray(0, np.int32)], body, config=config, listeners=self.listeners
        )
        if not check_loss and self.loss_history:  # one readback of the deferred scalars
            self.loss_history = [float(x) for x in torch.stack(self.loss_history).cpu().numpy()]
        return outputs[0]

    def _run_chunks(self, coef, starts, offsets, chunk: int, check_loss: bool,
                    epoch: Callable) -> torch.Tensor:
        """Run the epochs of the schedule ``(starts, offsets)`` in chunks of
        ``chunk``: ``done``, the losses and the executed count stay on the
        device within a chunk, and the host reads them once at its end. The
        losses are the reduced ones, the same on every rank, so every rank
        stops at the same epoch. Fills ``loss_history``."""
        tol = self.tol if check_loss else None
        done = torch.zeros((), dtype=torch.bool, device=coef.device)
        self.loss_history = []
        for starts_c, offsets_c, active_c, n_active in chunked_schedule(
            starts, offsets, self.max_iter, chunk
        ):
            coef, done, pending = _launch_chunk(coef, done, starts_c, offsets_c, active_c, epoch, tol)
            got = _read_losses(pending)  # the one host readback of the chunk
            self.loss_history.extend(got)
            if check_loss and len(got) < n_active:  # done flipped mid-chunk
                break
        return coef

    # -- one-hot sparse path ---------------------------------------------------

    _ONEHOT_MIN_DIM = 1 << 14
    _ONEHOT_MAX_WINDOWS = 64
    # Share of the device memory the packed stacks may claim under 'auto'.
    _ONEHOT_HBM_FRACTION = 0.35
    # Share the materialised premat one-hots plus the stacks may claim under
    # onehot_premat='auto' (the one-hots cost (row_hi + 128) * 2 B per slot).
    _ONEHOT_PREMAT_HBM_FRACTION = 0.55

    def _pick_onehot(self, sparse, train_data, local_batch, dim) -> bool:
        """Whether a sparse fit runs the one-hot path: forced by
        ``sparse_kernel='onehot'``, forbidden by ``'scatter'``; under
        ``'auto'`` for wide coefficients (``dim >= 2^14``), at least 2^16
        index slots over the whole (padded) data set and at most 64 windows,
        so every rank of a mesh decides alike. f32 only: the crossings carry
        values as split-bf16 pairs."""
        if not sparse or self.sparse_kernel == "scatter":
            return False
        host = train_data.host_columns
        feasible = "indices" in host and self.dtype == torch.float32
        if self.sparse_kernel == "onehot":
            if not feasible:
                raise ValueError(
                    "sparse_kernel='onehot' requires an f32 fit with host-readable "
                    "sparse columns; use 'auto' or 'scatter' for this configuration"
                )
            return True
        n_windows = -(-train_data.local_rows // local_batch)
        return (
            feasible
            and int(train_data["indices"].numel()) * train_data.n_data >= 1 << 16
            and n_windows <= self._ONEHOT_MAX_WINDOWS
            and dim >= self._ONEHOT_MIN_DIM
        )

    def _onehot_layout(self, train_data, dim, local_batch, force: bool):
        """Build (once per cache and batch) the one-hot layout and its
        device stacks ``(lidx, rowid, lvals, row_ptr, entry_of)``, memoised
        on the cache. Returns ``(layout, stacks)``; ``stacks`` is None when
        not ``force`` and they would overrun the memory budget."""
        import time

        from flink_ml_tpu_torch.linalg.onehot_sparse import OneHotSparseLayout, row_order

        ctx = train_data.ctx
        # the stacks (and the build form's row_order) are the rank's
        # (data, model) cell of the layout
        cell = (1, 1, 0, 0) if ctx is None else (ctx.n_data, ctx.n_model, ctx.data_index, ctx.model_index)
        key = (dim, local_batch) + cell
        memo = train_data._onehot_memo
        if memo is not None and memo[0] == key and (memo[2] is not None or not force):
            return memo[1], memo[2]
        dev = train_data.device
        budget = None if force else int(self._ONEHOT_HBM_FRACTION * _hbm_bytes_limit(dev))
        t0 = time.perf_counter()
        lay = OneHotSparseLayout.build(
            train_data.host_columns["indices"], train_data.host_columns["values"],
            dim, local_batch, max_stack_bytes=budget,
            n_shards=cell[0], shard=cell[2], n_model=cell[1], model_index=cell[3],
        )
        self.layout_seconds = time.perf_counter() - t0
        if lay is None:
            train_data._onehot_memo = (key, None, None)
            return None, None
        lidx = torch.from_numpy(lay.lidx).to(dev)
        rowid = torch.from_numpy(lay.rowid).to(dev)
        lvals = torch.from_numpy(np.asarray(lay.lvals, np.float32)).to(dev)
        row_ptr, entry_of = row_order(rowid, lay.row_hi, live=lvals != 0)
        stacks = (lidx, rowid, lvals, row_ptr, entry_of)
        train_data._onehot_memo = (key, lay, stacks)
        return lay, stacks

    def _premat_onehots(self, lay, stacks, train_data):
        """Decide the premat path (``onehot_premat`` 'on'/'off', or 'auto'
        against the memory budget) and materialise the run's row one-hots
        on the device from the resident rowid stacks, memoised on the cache.
        Returns ``(premat, (oh_hi, oh_lo) or ())``."""
        from flink_ml_tpu_torch.linalg.onehot_sparse import premat_bytes, premat_row_onehots

        if self.onehot_premat == "off":
            self._drop_premat_memo(train_data)
            return False, ()
        n_units = lay.n_windows * lay.n_sub
        need = premat_bytes(n_units, lay.n_flat, lay.row_hi) + 7 * n_units * lay.n_flat
        if (
            self.onehot_premat == "auto"
            and need > self._ONEHOT_PREMAT_HBM_FRACTION * _hbm_bytes_limit(train_data.device)
        ):
            self._drop_premat_memo(train_data)
            return False, ()
        key = (lay.dim, lay.local_batch, lay.row_hi, lay.n_model)
        memo = train_data._onehot_premat_memo
        if memo is not None and memo[0] == key:
            return True, memo[1]
        # free a stale configuration's one-hots before allocating new ones
        train_data._onehot_premat_memo = memo = None
        oh = premat_row_onehots(stacks[1], lay.row_hi)
        train_data._onehot_premat_memo = (key, oh)
        return True, oh

    @staticmethod
    def _drop_premat_memo(train_data) -> None:
        """Release memoised one-hots when a fit decides against the premat
        path, so an 'off' fit does not run beside gigabytes it never reads."""
        train_data._onehot_premat_memo = None

    def _optimize_onehot(self, init_model, train_data, loss_func, local_batch, check_loss, dim):
        from flink_ml_tpu_torch.linalg.onehot_sparse import BLOCK, onehot_batch_step

        lay, stacks = self._onehot_layout(
            train_data, dim, local_batch, force=self.sparse_kernel == "onehot"
        )
        if stacks is None:
            return None
        premat, oh = self._premat_onehots(lay, stacks, train_data)
        self.onehot_premat_active = premat
        lidx, rowid, lvals, row_ptr, entry_of = stacks
        # crossing MACs bound the chunk (split-bf16 doubles them)
        flops = 4.0 * lay.n_sub * lay.n_flat * (lay.sub_batch + 2 * BLOCK)
        chunk = fused_chunk_len(self.max_iter, check_loss, 0, flops)
        win_of = {s: i for i, s in enumerate(lay.window_starts)}
        y, w = train_data["labels"], train_data["weights"]
        mask = train_data.mask
        pad = lay.n_sub * lay.sub_batch - local_batch
        lr, reg, en, ctx = self.learning_rate, self.reg, self.elastic_net, train_data.ctx

        def epoch(coef_perm, start, offset):
            wi = win_of[start]
            yb, wb = _batch_rows(y, w, mask, start, offset, local_batch)
            if pad:
                yb, wb = F.pad(yb, (0, pad)), F.pad(wb, (0, pad))
            grad, loss_sum, wsum = onehot_batch_step(
                coef_perm, lidx[wi], rowid[wi], lvals[wi], yb, wb, loss_func,
                lay.class_meta, lay.nblk_local, lay.sub_batch, lay.row_hi,
                premat=(oh[0], oh[1], wi) if premat else None,
                order=None if premat else (row_ptr[wi], entry_of[wi]),
                model_ctx=ctx,
            )
            grad, loss_sum, wsum = all_reduce_packed((grad, loss_sum, wsum), ctx)
            return _apply_update(coef_perm, grad, wsum, loss_sum, lr, reg, en)

        # the rank's row of the shard-major [n_model, nblk_local * 128] coefficient
        coef = lay.permute_coef(np.asarray(init_model, np.float32)).reshape(lay.n_model, -1)
        coef = torch.from_numpy(coef[0 if ctx is None else ctx.model_index].copy())
        starts, offsets = offset_schedule(train_data.local_rows, local_batch, self.max_iter)
        coef = self._run_chunks(coef.to(train_data.device), starts, offsets, chunk, check_loss, epoch)
        if lay.n_model > 1:
            coef = _gather_model(coef, ctx)
        return lay.unpermute_coef(coef.cpu().numpy())

    # -- streamed (host-tier cache) paths ----------------------------------------

    def _optimize_streaming(self, init_model, cache, loss_func: LossFunc, ctx) -> np.ndarray:
        """Train out of a host-tier cache larger than the card (JAX :1651):
        per-shard windows stream through the resident epoch, one run of
        launches per window visit, the next window loaded while the device
        computes. With batch-aligned shards every epoch reads exactly the
        rows and weights the resident path would."""
        from flink_ml_tpu_torch.iteration.streaming import plan_windows

        if self.listeners:
            raise ValueError(
                "per-epoch listeners are not supported on the streamed "
                "(larger-than-device) path; train from a DeviceDataCache instead"
            )
        n_data = 1 if ctx is None else ctx.n_data
        n_rows = int(cache.num_rows)
        local_batch = min(-(-self.global_batch_size // n_data), -(-n_rows // n_data))
        row0 = cache.rows(0, 1)
        sparse = "indices" in row0
        if not sparse and self.sparse_kernel == "onehot":
            raise ValueError(
                "sparse_kernel='onehot' applies to sparse (indices/values) "
                "training data; this fit has dense features"
            )
        dim = int(np.asarray(init_model).shape[0])
        check_loss = bool(np.isfinite(self.tol) and self.tol > 0)
        device = ctx.device if ctx is not None else resolve_device(self.device)
        self.stream_stats = {"plan_s": 0.0}
        # A streamed sparse coefficient shards over the model axis (each
        # shard scatters its index range); a streamed dense one stays whole
        # on every model shard: windows ingest row-sharded only (JAX :1686).
        model_sharded = sparse and ctx is not None and ctx.n_model > 1
        K = int(np.asarray(row0["indices"]).shape[-1]) if sparse else 0
        if sparse and self._pick_onehot_streamed(n_rows, K, dim):
            result = self._optimize_streaming_onehot(init_model, cache, loss_func, ctx, local_batch, dim,
                                                     check_loss, n_rows, device)
            if result is not None:
                return result
            # auto: two windows' stacks would overrun the budget — scatter instead
        if sparse:
            columns = {"indices": "indices", "values": "values", "labels": "labels", "weights": "weights"}
        else:
            columns = {"features": "features", "labels": "labels", "weights": "weights"}
        np_dtype = _NP_DTYPES[self.dtype]
        stream, sched = plan_windows(
            cache, columns, ctx, self.stream_window_rows, local_batch, self.max_iter, dtype=np_dtype,
            dtypes={"indices": np.int32} if sparse else None,
            serial_elems_per_epoch=2 * local_batch * K,  # the gather and the scatter
            check_loss=check_loss, device=device,
        )
        lr, reg, en = self.learning_rate, self.reg, self.elastic_net
        part_ctx = ctx if model_sharded else None  # a whole coefficient sums its margins alone

        def epoch_of(win):
            feats = (win["indices"], win["values"]) if sparse else win["features"]
            y, w, mask = win["labels"], win["weights"], win["__mask__"]

            def epoch(coef, start, offset):
                grad, wsum, loss_sum = all_reduce_packed(
                    _sgd_partials(coef, start, offset, feats, y, w, mask, loss_func, local_batch, part_ctx), ctx)
                return _apply_update(coef, grad, wsum, loss_sum, lr, reg, en)

            return epoch

        def place(host_coef):
            return self._place_coef(ctx, np.asarray(host_coef)[:dim], device, model_sharded)

        def logical(coef):
            if model_sharded:
                coef = _gather_model(coef, ctx)
            return coef.cpu().numpy()[:dim]

        return self._run_streamed(stream, sched, loss_func, ctx, n_rows, dim, np.asarray(init_model),
                                  place, logical, epoch_of, {"window": sched.window, "streamed": True})

    def _pick_onehot_streamed(self, n_rows: int, K: int, dim: int) -> bool:
        """Whether a streamed sparse fit runs the one-hot path (JAX :1437):
        forced by 'onehot' (f32 only), forbidden by 'scatter'; under 'auto'
        for f32 fits of at least 2^16 index slots and ``dim >= 2^14``."""
        if self.sparse_kernel == "scatter":
            return False
        feasible = self.dtype == torch.float32
        if self.sparse_kernel == "onehot":
            if not feasible:
                raise ValueError(
                    "sparse_kernel='onehot' on the streamed path requires an "
                    "f32 fit; use 'auto' or 'scatter' for this configuration"
                )
            return True
        return feasible and n_rows * K >= 1 << 16 and dim >= self._ONEHOT_MIN_DIM

    def _premat_streamed(self, plan, n_mb: int, n_sub: int, device) -> bool:
        """The streamed premat decision (JAX :1319): nothing is memoised —
        each window's one-hots are made on the device as it lands and freed
        when it rotates out — so 'auto' budgets the two live windows'
        one-hots and stacks."""
        from flink_ml_tpu_torch.linalg.onehot_sparse import premat_bytes

        if self.onehot_premat != "auto":
            return self.onehot_premat == "on"
        n_units = n_mb * n_sub
        per_dev = 2 * (premat_bytes(n_units, plan.n_flat, plan.row_hi) + 7 * n_units * plan.n_flat)
        return per_dev <= self._ONEHOT_PREMAT_HBM_FRACTION * _hbm_bytes_limit(device)

    def _optimize_streaming_onehot(self, init_model, cache, loss_func, ctx, local_batch: int, dim: int,
                                   check_loss: bool, n_rows: int, device):
        """Streamed sparse SGD on the one-hot crossings (JAX :1457): one
        counting pass sizes a global ``OneHotSparsePlan``, each window's
        stacks are filled on the host against it inside the prefetch gap,
        and the resident one-hot epoch runs with the window's minibatches as
        its windows. Returns None when 'auto' finds two windows' stacks
        would overrun the budget (the caller then takes the scatter path)."""
        import time

        from flink_ml_tpu_torch.iteration.streaming import WindowSchedule
        from flink_ml_tpu_torch.linalg.onehot_sparse import BLOCK, SUB_ROWS, onehot_batch_step, premat_bytes

        n_data = 1 if ctx is None else ctx.n_data
        n_model = 1 if ctx is None else ctx.n_model
        m = -(-n_rows // n_data)
        b = local_batch
        W = max(b, min(int(self.stream_window_rows), m))  # WindowSchedule's batch-aligned width
        W = -(-W // b) * b
        n_mb = -(-min(W, m) // b)
        sub = min(SUB_ROWS, b)
        n_sub = -(-b // sub)
        t0 = time.perf_counter()
        plan = streamed_onehot_plan(cache, n_rows, n_data, W, b, dim, n_model)
        self.layout_seconds = self.stream_stats["plan_s"] = time.perf_counter() - t0
        if self.sparse_kernel != "onehot":
            # two windows of stacks live at once; stack_bytes counts every model shard
            per_dev = 2 * plan.stack_bytes(n_mb * n_sub) // max(1, n_model)
            if per_dev > self._ONEHOT_HBM_FRACTION * _hbm_bytes_limit(device):
                return None
        flops = 4.0 * n_sub * plan.n_flat * (sub + 2 * BLOCK)
        sched = WindowSchedule(m, b, self.stream_window_rows, self.max_iter, check_loss=check_loss,
                               flops_per_epoch=flops)
        premat = self._premat_streamed(plan, n_mb, n_sub, device)
        self.onehot_premat_active = premat
        units = n_mb * n_sub
        # one window on the device: its stacks, its one-hots or row order,
        # its label, weight and mask rows
        self.stream_stats["window_bytes"] = 7 * units * plan.n_flat + 12 * W + (
            premat_bytes(units, plan.n_flat, plan.row_hi) if premat
            else 4 * units * (plan.row_hi * 128 + 1 + plan.n_flat))
        stream = _OneHotWindowStream(cache, ctx, plan, W, b, n_sub, premat, device)
        pad = n_sub * plan.sub_batch - b
        lr, reg, en = self.learning_rate, self.reg, self.elastic_net

        def epoch_of(win):
            lidx, rowid, lvals = win["lidx"], win["rowid"], win["lvals"]
            y, w, mask = win["labels"], win["weights"], win["__mask__"]
            oh, order = win.get("oh"), win.get("order")

            def epoch(coef_perm, start, offset):
                wi = start // b  # a window's minibatches are the resident layout's windows
                yb, wb = _batch_rows(y, w, mask, start, offset, b)
                if pad:
                    yb, wb = F.pad(yb, (0, pad)), F.pad(wb, (0, pad))
                grad, loss_sum, wsum = onehot_batch_step(
                    coef_perm, lidx[wi], rowid[wi], lvals[wi], yb, wb, loss_func,
                    plan.class_meta, plan.nblk_local, plan.sub_batch, plan.row_hi,
                    premat=(oh[0], oh[1], wi) if premat else None,
                    order=None if premat else (order[0][wi], order[1][wi]),
                    model_ctx=ctx,
                )
                grad, loss_sum, wsum = all_reduce_packed((grad, loss_sum, wsum), ctx)
                return _apply_update(coef_perm, grad, wsum, loss_sum, lr, reg, en)

            return epoch

        def place(host_coef):
            # the rank's row of the shard-major [n_model, nblk_local * 128] coefficient
            coef = plan.permute_coef(np.asarray(host_coef, np.float32)[:dim]).reshape(n_model, -1)
            return torch.from_numpy(coef[0 if ctx is None else ctx.model_index].copy()).to(device)

        def logical(coef):
            if n_model > 1:
                coef = _gather_model(coef, ctx)
            return plan.unpermute_coef(coef.cpu().numpy())

        return self._run_streamed(stream, sched, loss_func, ctx, n_rows, dim, np.asarray(init_model),
                                  place, logical, epoch_of,
                                  {"window": W, "streamed": True, "kernel": "onehot"})

    def _run_streamed(self, stream, sched, loss_func, ctx, n_rows: int, dim: int, coef_host,
                      place: Callable, logical: Callable, epoch_of: Callable, extra: dict) -> np.ndarray:
        """The window loop both streamed paths share (JAX :1521-1597 and
        :1741-1825): resume from the manager's newest snapshot, queue one
        run a window visit (``dispatch``, which reads nothing back), and in
        ``observe`` read the losses when ``tol`` needs them (else they stay
        pending until the end, or the next snapshot) and snapshot
        ``{next_run, coef, done, loss_history}`` at run boundaries once
        ``checkpoint_interval`` epochs have passed; the saved coefficient is
        the logical one and the saved history holds every epoch before it
        (the JAX package saves only the losses it has read, :1586).
        ``place``/``logical`` map a host coefficient to the device layout and
        back."""
        import time

        from flink_ml_tpu_torch.iteration.streaming import run_windows

        mgr = self.checkpoint_manager
        n_data, n_model = (1, 1) if ctx is None else (ctx.n_data, ctx.n_model)
        if mgr is not None and n_data * n_model > 1 and not isinstance(mgr, ShardedCheckpointManager):
            raise ValueError(
                "a checkpointed fit on a mesh of several ranks needs a ShardedCheckpointManager "
                "(rank 0 writes, the others wait); a CheckpointManager would be written by every rank"
            )
        check_loss = bool(np.isfinite(self.tol) and self.tol > 0)
        tol = self.tol if check_loss else None
        start_run, done_host = 0, False
        self.loss_history = []
        if mgr is not None:
            mgr.set_fingerprint(self._run_fingerprint(loss_func, n_rows, dim, n_data, n_model, extra))
            restored = mgr.restore_latest()
            if restored is not None:
                _, st = restored
                start_run = int(np.asarray(st["next_run"]))
                coef_host = np.asarray(st["coef"].cpu() if isinstance(st["coef"], torch.Tensor) else st["coef"])
                done_host = bool(np.asarray(st["done"].cpu() if isinstance(st["done"], torch.Tensor) else st["done"]))
                self.loss_history = [float(x) for x in np.asarray(st["loss_history"]).reshape(-1)]
        coef = place(coef_host)
        device = coef.device
        state = {"coef": coef, "done": torch.tensor(done_host, device=device),
                 "epochs": sum(len(s) for _, s in sched.runs[:start_run]), "last_saved": None, "runs": 0}
        pending: list = []
        events: list = []

        def dispatch(i, win, starts_c, active_c, n_active):
            epoch = epoch_of(win)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) \
                if device.type == "cuda" else None
            if ev is not None:
                ev[0].record()
            # starts double as offsets: the window's masked padding is the short tail batch
            state["coef"], state["done"], losses = _launch_chunk(state["coef"], state["done"], starts_c,
                                                                 starts_c, active_c, epoch, tol)
            if ev is not None:
                ev[1].record()
                events.append(ev)
            state["epochs"] += n_active
            state["runs"] += 1

            def observe():
                stop = False
                if check_loss:
                    got = _read_losses(losses)
                    self.loss_history.extend(got)
                    stop = len(got) < n_active  # done flipped mid-run
                else:
                    pending.append(losses)
                if mgr is not None and self.checkpoint_interval > 0:
                    last = state["last_saved"]
                    if last is None or state["epochs"] - last >= self.checkpoint_interval:
                        for got in pending:  # one readback a snapshot; saving reads the coefficient anyway
                            self.loss_history.extend(_read_losses(got))
                        pending.clear()
                        mgr.save(state["epochs"], {
                            "next_run": i + 1,
                            "coef": logical(state["coef"]),
                            "done": np.asarray(bool(state["done"])),
                            "loss_history": np.asarray(self.loss_history, np.float64),
                        })
                        state["last_saved"] = state["epochs"]
                return stop

            return observe

        t0 = time.perf_counter()
        self.stream_stats["load_s"] = run_windows(stream, sched, dispatch, start_run=start_run)
        self.stream_stats["load_parts"] = stream.parts
        for losses in pending:  # one readback of runs that have finished or are queued
            self.loss_history.extend(_read_losses(losses))
        result = logical(state["coef"])
        self.stream_stats["loop_s"] = time.perf_counter() - t0
        self.stream_stats["run_ms"] = [a.elapsed_time(b) for a, b in events]
        self.stream_stats["runs"] = state["runs"]
        return result
