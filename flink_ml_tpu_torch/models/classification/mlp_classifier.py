"""MLP classifier — twin of ``flink_ml_tpu/models/classification/mlp_classifier.py``
on one device or a mesh.

A fully connected relu network with a softmax head, trained by minibatch
adam on softmax cross-entropy. The network is an ``nn.Module`` that keeps
the JAX package's ``W [d_in, d_out]`` layout, so model data crosses between
the packages unchanged; both draw their initial weights from the same numpy
generator, so a fit starts from bit-equal weights.

fit: the dataset is resident on the device (``DeviceDataCache``); each epoch
reads the schedule's contiguous window with its clamped tail zero-weighted
(``_batch_rows``, as SGD does), takes the gradient of the weighted loss sum
by autograd, divides it by the window's weight, and applies adam written
out in optax's order (``_adam_step``). Epochs run in chunks
(``fused_chunk_len``): the ``tol`` criterion's ``done`` flag and the
per-epoch losses stay on the device within a chunk and are read once at its
end. ``computeType=bfloat16`` casts each matrix product's operands to
bfloat16, as ``_forward`` does in the JAX package; parameters, optimizer
state and loss stay float32.

On ``train.mesh`` (JAX :317-345) the mesh is a data-parallel knob: every
rank is handed the whole input and uploads its contiguous share
(``DeviceDataCache`` on the mesh); each epoch it takes ``ceil(B / N)`` rows
of its share, all-reduces the packed gradients, weight and loss sums, and
every rank runs the same adam step. The global minibatch changes with the
width and the all-reduce sums in the library's order, so this fit is outside
the bit contract of SGD and KMeans, as it is in the JAX package.

fit_stream (JAX :385): the rows stream out of a host-tier cache (columns
``features``, ``labels`` — class values, mapped to indices into
``classes`` and refused when outside them — and optional ``weights``)
through ``iteration/streaming.py``'s ``plan_windows``/``run_windows``: the
resident fit's epochs (``_AdamRun``) run on each window while the next one
is read and copied, every epoch whose minibatch lies in the window in one
run. On ``train.mesh`` each rank streams its own data shard's rows, as the
resident fit uploads its share. With batch-aligned shards every epoch reads
the rows the resident fit would.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.common import extract_labeled_data
from flink_ml_tpu_torch.ops.kernels import mlp_predict_fn
from flink_ml_tpu_torch.ops.optimizer import _batch_rows, _read_losses, fused_chunk_len
from flink_ml_tpu_torch.ops.schedule import chunked_schedule, offset_schedule
from flink_ml_tpu_torch.parallel.collectives import all_reduce_packed
from flink_ml_tpu_torch.parallel.train_sharding import resolve_train_sharding
from flink_ml_tpu_torch.params.param import (
    IntArrayParam,
    ParamValidators,
    StringParam,
    update_existing_params,
)
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasSeed,
    HasTol,
)
from flink_ml_tpu_torch.servable.lib import MLPClassifierModelServable
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["MLPClassifier", "MLPClassifierModel"]

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class _MlpParams(
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasLearningRate,
    HasGlobalBatchSize,
    HasTol,
    HasSeed,
):
    HIDDEN_LAYERS = IntArrayParam(
        "hiddenLayers",
        "Sizes of the hidden layers.",
        [64],
        ParamValidators.non_empty_array(),
    )
    COMPUTE_TYPE = StringParam(
        "computeType",
        "Matmul compute dtype: 'bfloat16' runs forward/backward matmuls on "
        "the MXU's native bf16 path (params, optimizer state and loss stay "
        "float32 — standard mixed precision); 'float32' is exact.",
        "float32",
        ParamValidators.in_array(["float32", "bfloat16"]),
    )

    def get_hidden_layers(self):
        return self.get(self.HIDDEN_LAYERS)

    def set_hidden_layers(self, *values: int):
        return self.set(self.HIDDEN_LAYERS, list(values))

    def get_compute_type(self) -> str:
        return self.get(self.COMPUTE_TYPE)

    def set_compute_type(self, value: str):
        return self.set(self.COMPUTE_TYPE, value)

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.get_compute_type() == "bfloat16" else None


def _mlp_flops_per_epoch(dims: Sequence[int], local_batch: int, n_data: int = 1) -> float:
    """Matrix-product FLOPs of one global minibatch epoch (forward 2 +
    backward 4 per weight per row): the chunk-length cost model's input."""
    return 6.0 * local_batch * n_data * sum(a * b for a, b in zip(dims[:-1], dims[1:]))



def _init_params(rng: np.random.Generator, dims: List[int]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """He-normal weights and zero biases, drawn exactly as the JAX package
    draws them."""
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        scale = np.sqrt(2.0 / d_in)
        params.append(
            (
                (rng.normal(size=(d_in, d_out)) * scale).astype(np.float32),
                np.zeros(d_out, np.float32),
            )
        )
    return params


def _forward(layers, X: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Logits. With ``compute_dtype`` the inputs, weights and biases are cast
    per matrix product; the casts are differentiable, so gradients come back
    in the parameters' float32."""
    cast = (lambda a: a.to(compute_dtype)) if compute_dtype is not None else (lambda a: a)
    h = cast(X)
    for W, b in layers[:-1]:
        h = torch.relu(h @ cast(W) + cast(b))
    W, b = layers[-1]
    return h @ cast(W) + cast(b)


class _MLP(nn.Module):
    """The network: ``W{i} [d_in, d_out]`` and ``b{i} [d_out]`` per layer."""

    def __init__(self, layers, device: torch.device):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.ascontiguousarray(W, np.float32)).to(device)) for W, _ in layers
        )
        self.biases = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device)) for _, b in layers
        )

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return list(zip(self.weights, self.biases))

    def forward(self, X: torch.Tensor, compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return _forward(self.layers(), X, compute_dtype)


def _predict(layers, X: torch.Tensor, compute_dtype: Optional[torch.dtype]):
    """``(argmax class index as float32, probabilities)``: float32 through
    ``mlp_predict_fn``, the serving body; bfloat16 through ``_forward``'s
    casts, then the same float32 head."""
    if compute_dtype is None:
        return mlp_predict_fn(layers, X)
    logits = _forward(layers, X, compute_dtype).to(torch.float32)
    return torch.argmax(logits, dim=-1).to(torch.float32), torch.softmax(logits, dim=-1)


class MLPClassifierModel(Model, _MlpParams):
    """Serving side: one forward pass; prediction = ``labels[argmax]``."""

    def __init__(self):
        super().__init__()
        self.params: Optional[list] = None  # [(W [d_in, d_out], b [d_out]), ...] float32
        self.labels: Optional[np.ndarray] = None  # [classes] class values

    def transform(self, *inputs, device=None):
        """prediction (DOUBLE) and the class probabilities (a vector
        column) on ``device`` (None → the GPU), at the model's computeType."""
        (df,) = inputs
        if self.params is None:
            raise RuntimeError("model must be fit/loaded before transform")
        dev = resolve_device(device)
        X = torch.from_numpy(np.ascontiguousarray(df.vectors(self.get_features_col()), np.float32)).to(dev)
        layers = [
            tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in layer)
            for layer in self.params
        ]
        with torch.no_grad():
            pred_idx, probs = _predict(layers, X, self._compute_dtype())
        pred = np.asarray(self.labels)[pred_idx.cpu().numpy().astype(np.int64)]
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, np.asarray(pred, np.float64))
        out.add_column(
            self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE),
            probs.cpu().numpy().astype(np.float64),
        )
        return out

    # --- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        rw.save_metadata(self, path, {"numLayers": len(self.params)})
        arrays = {"labels": self.labels}
        for i, (W, b) in enumerate(self.params):
            arrays[f"W{i}"] = np.asarray(W)
            arrays[f"b{i}"] = np.asarray(b)
        rw.save_model_arrays(path, arrays)

    @classmethod
    def load(cls, path: str):
        """Load a directory saved by this class or by its JAX twin."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        model = cls()
        model.load_param_map_from_json(metadata["paramMap"])
        arrays = rw.load_model_arrays(path)
        model.labels = arrays["labels"]
        model.params = [(arrays[f"W{i}"], arrays[f"b{i}"]) for i in range(metadata["numLayers"])]
        return model

    @classmethod
    def load_servable(cls, path: str) -> MLPClassifierModelServable:
        """The runtime-free servable of this model's save directory."""
        return MLPClassifierModelServable.load_servable(path)

    def get_model_data(self):
        """The JAX package's layout: one row of ``params`` (the list of
        ``(W, b)`` pairs) and ``labels``."""
        return [DataFrame(["params", "labels"], None, [[self.params], [self.labels]])]

    def set_model_data(self, *model_data):
        """Takes :meth:`get_model_data`'s layout, from either package."""
        df = model_data[0]
        self.params = [
            (np.asarray(W, np.float32), np.asarray(b, np.float32)) for W, b in df.column("params")[0]
        ]
        self.labels = np.asarray(df.column("labels")[0])
        return self


def _adam_step(params, grads, mu, nu, t: int, lr: float):
    """One adam step in optax's order (``scale_by_adam`` then
    ``scale_by_learning_rate``): the moments, their bias corrections with
    ``1 − b^t`` taken in float32, ``mu_hat / (sqrt(nu_hat) + eps)``, that
    update times ``−lr``, added to the parameter. ``torch.optim.Adam`` rounds
    in another order, so it is not used. Returns ``(new param, mu, nu)``
    per parameter; the caller keeps or discards the step."""
    bc1 = float(np.float32(1.0) - np.float32(_B1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(_B2) ** np.float32(t))
    stepped = []
    for p, g, m, v in zip(params, grads, mu, nu):
        m = (1.0 - _B1) * g + _B1 * m
        v = (1.0 - _B2) * (g * g) + _B2 * v
        update = (m / bc1) / (torch.sqrt(v / bc2) + _EPS) * -lr
        stepped.append((p + update, m, v))
    return stepped


class _AdamRun:
    """One adam fit's state on its device — the network, the moments, the
    step count and the ``done`` flag — and its epochs, queued a chunk at a
    time without reading anything back (the JAX fused chunk program)."""

    def __init__(self, net: _MLP, lr: float, compute_dtype, local_batch: int, ctx, tol: Optional[float],
                 device):
        self.net = net
        self.params = list(net.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self.done = torch.zeros((), dtype=torch.bool, device=device)
        self.lr, self.compute_dtype, self.local_batch, self.ctx, self.tol = lr, compute_dtype, local_batch, ctx, tol

    def launch(self, X, y, w, mask, starts_c, offsets_c, active_c):
        """Queue the chunk's epochs on ``X``/``y``/``w``/``mask``: each reads
        the schedule's window with its clamped tail zero-weighted
        (``_batch_rows``), takes the weighted loss sum's gradient by
        autograd, all-reduces gradients, weight and loss over the data axes,
        divides by the weight and applies ``_adam_step``; ``done`` freezes
        the parameters under ``tol``. Returns the pending ``(recorded
        losses, executed count)``."""
        params, b = self.params, self.local_batch
        recorded = []
        executed_n = torch.zeros((), dtype=torch.float32, device=self.done.device)
        for start, offset, act in zip(starts_c, offsets_c, active_c):
            if not act:  # padding epochs of the last chunk: no-ops
                continue
            start = int(start)
            yb, wb = _batch_rows(y, w, mask, start, int(offset), b)
            logits = self.net(X[start:start + b], self.compute_dtype).to(torch.float32)
            losses = torch.logsumexp(logits, dim=-1) - logits.gather(1, yb.long()[:, None])[:, 0]
            loss_sum = torch.sum(losses * wb)
            grads = torch.autograd.grad(loss_sum, params)
            with torch.no_grad():
                # JAX _epoch_math's psum of (grads, [weight, loss]), packed
                *grads, loss_sum, wsum = all_reduce_packed([*grads, loss_sum.detach(), torch.sum(wb)], self.ctx)
                safe_w = torch.clamp(wsum, min=1e-30)
                # optax's count advances on executed epochs only; once
                # ``done``, no later epoch of the run is kept anyway
                self.t += 1
                stepped = _adam_step(params, [g / safe_w for g in grads], self.mu, self.nu, self.t, self.lr)
                mean_loss = loss_sum / safe_w
                executed = ~self.done
                for i, (p_new, m_new, v_new) in enumerate(stepped):
                    if self.tol is not None:
                        p_new = torch.where(executed, p_new, params[i])
                        m_new = torch.where(executed, m_new, self.mu[i])
                        v_new = torch.where(executed, v_new, self.nu[i])
                    params[i].copy_(p_new)
                    self.mu[i], self.nu[i] = m_new, v_new
                recorded.append(torch.where(executed, mean_loss, torch.full_like(mean_loss, np.inf)))
                executed_n = executed_n + executed.to(torch.float32)
                if self.tol is not None:  # stop once loss < tol (NaN continues)
                    self.done = self.done | (executed & (mean_loss < self.tol))
        return recorded, executed_n

    def layers(self) -> list:
        return [(W.detach().cpu().numpy(), b.detach().cpu().numpy()) for W, b in self.net.layers()]


class MLPClassifier(Estimator, _MlpParams):
    """Minibatch adam training of the MLP on one device."""

    def fit(self, *inputs, device=None) -> MLPClassifierModel:
        """Train on ``device`` (None → the GPU). Records ``loss_history``
        (the mean loss of every executed epoch) on the estimator."""
        (df,) = inputs
        data = extract_labeled_data(df, self.get_features_col(), self.get_label_col(), None)
        classes = np.unique(data["labels"])
        y_idx = np.searchsorted(classes, data["labels"]).astype(np.float32)
        ts = resolve_train_sharding(device)
        cache = DeviceDataCache(
            {"x": data["features"], "y": y_idx, "w": data["weights"]}, device=device,
            ctx=None if ts is None else ts.ctx,
        )
        model = self.fit_cache(cache, classes)
        if ts is not None:
            metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        return model

    def _adam_run(self, dims: List[int], local_batch: int, ctx, device) -> _AdamRun:
        tol = self.get_tol()
        net = _MLP(_init_params(np.random.default_rng(self.get_seed()), dims), device)
        return _AdamRun(net, self.get_learning_rate(), self._compute_dtype(), local_batch, ctx,
                        tol if np.isfinite(tol) and tol > 0 else None, device)

    def _model(self, run: _AdamRun, classes) -> MLPClassifierModel:
        model = MLPClassifierModel()
        update_existing_params(model, self)
        model.params = run.layers()
        model.labels = np.asarray(classes, np.float64)
        return model

    def fit_cache(self, cache: DeviceDataCache, classes: np.ndarray) -> MLPClassifierModel:
        """The resident fit on ``cache``: columns ``x`` [n, d] float32, ``y``
        [n] the class index (float32) into ``classes``, ``w`` [n] weights.
        A cache on a mesh trains data-parallel over its ranks."""
        X, y, w = cache["x"], cache["y"], cache["w"]
        dims = [int(X.shape[1]), *[int(h) for h in self.get_hidden_layers()], len(classes)]
        local_batch = min(-(-self.get_global_batch_size() // cache.n_data), cache.local_rows)
        run = self._adam_run(dims, local_batch, cache.ctx, cache.device)
        check_loss = run.tol is not None
        max_iter = self.get_max_iter()
        chunk = fused_chunk_len(
            max_iter, check_loss, flops_per_epoch=_mlp_flops_per_epoch(dims, local_batch, cache.n_data)
        )
        starts, offsets = offset_schedule(cache.local_rows, local_batch, max_iter)
        self.loss_history = []
        for starts_c, offsets_c, active_c, n_active in chunked_schedule(starts, offsets, max_iter, chunk):
            got = _read_losses(run.launch(X, y, w, cache.mask, starts_c, offsets_c, active_c))
            self.loss_history.extend(got)
            if check_loss and len(got) < n_active:  # done flipped mid-chunk
                break
        return self._model(run, classes)

    def fit_stream(self, cache, classes=None, window_rows=None, device=None) -> MLPClassifierModel:
        """Train out of a host-tier cache larger than the card on ``device``
        (None → the GPU; on ``train.mesh``, this rank's card). ``classes``
        None: the cache's distinct labels, read in one pass. ``window_rows``
        None: ``train.stream.window.rows``. Records ``loss_history``."""
        from flink_ml_tpu_torch.config import Options, config
        from flink_ml_tpu_torch.iteration.streaming import plan_windows, run_windows

        if window_rows is None:  # the config tier decides
            window_rows = config.get(Options.TRAIN_STREAM_WINDOW_ROWS)
        ts = resolve_train_sharding(device)
        ctx = None if ts is None else ts.ctx
        dev = ctx.device if ctx is not None else resolve_device(device)
        n_data = 1 if ctx is None else ctx.n_data
        if classes is None:
            uniq: set = set()
            for chunk in cache.iter_rows():
                uniq.update(np.unique(np.asarray(chunk["labels"])).tolist())
            classes = sorted(uniq)
        classes = np.sort(np.asarray(classes, np.float64))

        def to_index(a):
            a64 = a.astype(np.float64)
            idx = np.searchsorted(classes, a64)
            bad = (idx >= len(classes)) | (classes[np.minimum(idx, len(classes) - 1)] != a64)
            if bad.any():  # a silent mis-map would train on wrong targets
                raise ValueError(f"labels {np.unique(a64[bad])} not in classes {classes}")
            return idx

        local_batch = max(1, -(-self.get_global_batch_size() // n_data))
        local_batch = min(local_batch, -(-int(cache.num_rows) // n_data))
        max_iter = self.get_max_iter()
        d = int(np.asarray(cache.rows(0, 1)["features"]).shape[-1])
        dims = [d, *[int(h) for h in self.get_hidden_layers()], len(classes)]
        run = self._adam_run(dims, local_batch, ctx, dev)
        check_loss = run.tol is not None
        stream, sched = plan_windows(
            cache, {"x": "features", "y": "labels", "w": "weights"}, ctx, window_rows, local_batch, max_iter,
            transforms={"y": to_index}, check_loss=check_loss,
            flops_per_epoch=_mlp_flops_per_epoch(dims, local_batch, n_data), device=dev,
        )
        if ts is not None:
            metrics.counter(MLMetrics.TRAIN_GROUP, MLMetrics.TRAIN_SHARDED_FITS)
        self.loss_history = []
        pending = []

        def dispatch(i, win, starts_c, active_c, n_active):
            # starts double as offsets: the window's masked padding is the short tail batch
            losses = run.launch(win["x"], win["y"], win["w"], win["__mask__"], starts_c, starts_c, active_c)

            def observe():
                if not check_loss:
                    pending.append(losses)
                    return False
                got = _read_losses(losses)
                self.loss_history.extend(got)
                return len(got) < n_active  # done mid-run

            return observe

        run_windows(stream, sched, dispatch)
        for losses in pending:
            self.loss_history.extend(_read_losses(losses))
        return self._model(run, classes)
