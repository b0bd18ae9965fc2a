"""Self-attention sequence classifier — twin of
``flink_ml_tpu/models/classification/attention_classifier.py``.

Architecture, as in the JAX package: token embedding → one multi-head
self-attention block with a residual → masked mean-pool over the real
positions → softmax head. The q/k/v/o projections and the head are plain
matrix products (``torch.matmul``, as the JAX package leaves them to XLA);
the attention runs through ``parallel/ring.py``, whose fold is the CUDA
kernel ``csrc/flash_fold.cu`` on the card and the plain fold on the CPU.

In a ``torch.distributed`` world of N ranks (the JAX twin's mesh data axis,
:116-187) ``fit`` and ``transform`` split the sequence over the ranks: the
tokens are padded with token 0 to a multiple of N (``n_valid`` masks the
padding from the keys and the pool), each rank embeds its T / N positions,
the ring rotates the K/V blocks between ranks, and the masked mean-pool is
summed over the ranks, so every rank computes the same logits. The
fold's kernels are gated at the local length T / N. With one process and no
group nothing is split. Parameters keep the JAX layout (``emb [vocab, E]``, ``wq``/``wk``/
``wv``/``wo [E, E]``, ``w_cls [E, C]``, ``b_cls [C]``), so model data
crosses between the packages unchanged.

Training (``SelfAttentionClassifier.fit``): adam on the weighted softmax
cross-entropy of a contiguous window of documents per step, the window
cycling as in the JAX package with the clamped tail's re-read rows weighted
0. The gradient is ``torch.autograd`` through ``_forward``; the fold's part
of it is the fold's own backward (``parallel/flash.py``): the dq and dkv
kernels of ``csrc/flash_fold_bwd.cu`` on the card, the plain VJP on the
CPU. On a world of ranks each rank's gradients of the embedding and the
projections are its slice's partials, summed over the ranks before adam
(JAX :156-161); the head's are already whole on every rank. Adam is
``mlp_classifier.py``'s ``_adam_step`` (optax's order).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.classification.mlp_classifier import _adam_step
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators, update_existing_params
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasSeed,
)
from flink_ml_tpu_torch.parallel.collectives import all_reduce_packed, psum_replicated
from flink_ml_tpu_torch.parallel.flash import MAX_HEAD_DIM, flash_train_available
from flink_ml_tpu_torch.parallel.mesh import DATA_AXIS, sequence_mesh
from flink_ml_tpu_torch.parallel.ring import ring_attention
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["SelfAttentionClassifier", "SelfAttentionClassifierModel"]


class _AttnParams(
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasLearningRate,
    HasGlobalBatchSize,
    HasSeed,
):
    EMBEDDING_DIM = IntParam(
        "embeddingDim", "Token embedding width.", 32, ParamValidators.gt(0)
    )
    NUM_HEADS = IntParam(
        "numHeads",
        "Attention heads; embeddingDim must divide evenly by it.",
        4,
        ParamValidators.gt(0),
    )
    VOCAB_SIZE = IntParam(
        "vocabSize",
        "Token vocabulary size; 0 infers max(token) + 1 from the training data.",
        0,
        ParamValidators.gt_eq(0),
    )

    def get_embedding_dim(self) -> int:
        return self.get(self.EMBEDDING_DIM)

    def set_embedding_dim(self, value: int):
        return self.set(self.EMBEDDING_DIM, value)

    def get_num_heads(self) -> int:
        return self.get(self.NUM_HEADS)

    def set_num_heads(self, value: int):
        return self.set(self.NUM_HEADS, value)

    def get_vocab_size(self) -> int:
        return self.get(self.VOCAB_SIZE)

    def set_vocab_size(self, value: int):
        return self.set(self.VOCAB_SIZE, value)


def _init_params(rng: np.random.Generator, vocab: int, emb: int, n_classes: int) -> Dict[str, np.ndarray]:
    """Glorot-normal weights and a zero bias, drawn exactly as the JAX
    package draws them."""

    def glorot(shape):
        scale = np.sqrt(2.0 / sum(shape))
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "emb": glorot((vocab, emb)),
        "wq": glorot((emb, emb)),
        "wk": glorot((emb, emb)),
        "wv": glorot((emb, emb)),
        "wo": glorot((emb, emb)),
        "w_cls": glorot((emb, n_classes)),
        "b_cls": np.zeros(n_classes, np.float32),
    }


#: The parameters whose gradient on a rank is its sequence slice's partial.
_SEQUENCE_PARAMS = ("emb", "wq", "wk", "wv", "wo")


def _forward(params: Dict[str, torch.Tensor], tok: torch.Tensor, n_valid: int, n_heads: int,
             ctx=None) -> torch.Tensor:
    """Logits [B, C] for token ids ``tok`` [B, T] of real length ``n_valid``:
    keys at positions >= ``n_valid`` are masked out of the attention and the
    pool, as in the JAX package. With ``ctx`` (a world of ranks) ``tok`` is
    this rank's slice of the sequence, at global positions ``i·T``, and the
    pool is summed over the ranks. On the card the fold is the kernel, which
    raises ``ValueError`` for a head dim past its limit."""
    B, T = tok.shape
    E = params["emb"].shape[1]
    h = params["emb"][tok]  # [B, T, E]
    q = (h @ params["wq"]).reshape(B, T, n_heads, E // n_heads)
    k = (h @ params["wk"]).reshape(B, T, n_heads, E // n_heads)
    v = (h @ params["wv"]).reshape(B, T, n_heads, E // n_heads)
    attn = ring_attention(q, k, v, causal=False, n_valid=n_valid, ctx=ctx)
    a = attn.reshape(B, T, E) @ params["wo"] + h  # residual
    pos0 = 0 if ctx is None else ctx.axis_index(DATA_AXIS) * T
    valid = (torch.arange(pos0, pos0 + T, device=tok.device) < n_valid).to(a.dtype)
    pooled = psum_replicated(torch.sum(a * valid[None, :, None], dim=1), ctx, DATA_AXIS) / float(n_valid)
    return pooled @ params["w_cls"] + params["b_cls"]


def _loss_and_grads(params: Dict[str, torch.Tensor], tok: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    n_valid: int, n_heads: int, ctx=None):
    """The window's weighted mean softmax cross-entropy, ``sum(losses · w) /
    max(sum(w), 1e-30)`` (optax's ``softmax_cross_entropy_with_integer_labels``
    per document), and its gradient in each parameter, by autograd through
    :func:`_forward`; on a world of ranks the sequence parameters' partials
    summed over the ranks. Returns ``(loss, {name: grad})``, detached."""
    leaves = {name: p.detach().requires_grad_(True) for name, p in params.items()}
    logits = _forward(leaves, tok, n_valid, n_heads, ctx)
    losses = torch.logsumexp(logits, dim=-1) - logits.gather(1, y[:, None])[:, 0]
    loss = torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1e-30)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if ctx is not None:
        names = [n for n in _SEQUENCE_PARAMS if n in grads]
        grads.update(zip(names, all_reduce_packed([grads[n] for n in names], ctx, DATA_AXIS)))
    return loss.detach(), grads


def _train_step(params: Dict[str, torch.Tensor], mu, nu, t: int, tok, y, w, n_valid: int, n_heads: int,
                lr: float, ctx=None):
    """One adam step (step number ``t`` from 1) on one window: the twin of
    the JAX package's ``_train_step``. ``mu``/``nu`` are the moments by
    parameter name. Returns ``(params, mu, nu, loss)``, new dicts."""
    loss, grads = _loss_and_grads(params, tok, y, w, n_valid, n_heads, ctx)
    names = list(params)
    with torch.no_grad():
        stepped = _adam_step([params[n] for n in names], [grads[n] for n in names],
                             [mu[n] for n in names], [nu[n] for n in names], t, lr)
    new_params, new_mu, new_nu = ({n: s[i] for n, s in zip(names, stepped)} for i in range(3))
    return new_params, new_mu, new_nu, loss


def _use_flash_train(tok: np.ndarray, emb: int, n_heads: int, batch: int, device, n_shards: int = 1) -> bool:
    """Whether the fold's kernels run this training step's shape on
    ``device`` (``flash_train_available`` at the local length T /
    ``n_shards``). On the card the fold has no other route, so ``fit``
    refuses a shape they do not run; the CPU runs the plain fold and its
    VJP."""
    return flash_train_available(tok.shape[1] // n_shards, emb // n_heads, batch, n_heads, device)


def _pad_tokens(tok: np.ndarray, n_shards: int = 1):
    """Pad the sequence axis to a multiple of ``n_shards`` with token 0,
    which ``n_valid`` masks from the attention keys and the pool (JAX
    :220-230). Returns ``(tokens, real length)``."""
    T = tok.shape[1]
    pad = (-T) % n_shards
    if pad:
        tok = np.concatenate([tok, np.zeros((tok.shape[0], pad), tok.dtype)], axis=1)
    return tok, T


def _n_shards(ctx) -> int:
    return 1 if ctx is None else ctx.axis_group(DATA_AXIS)[1]


def _local_tokens(tok: np.ndarray, ctx) -> np.ndarray:
    """This rank's contiguous slice of the (padded) sequence axis."""
    if ctx is None:
        return tok
    t = tok.shape[1] // _n_shards(ctx)
    i = ctx.axis_index(DATA_AXIS)
    return np.ascontiguousarray(tok[:, i * t:(i + 1) * t])


class SelfAttentionClassifierModel(Model, _AttnParams):
    """Serving side: one forward pass of the whole batch;
    prediction = ``labels[argmax]``."""

    def __init__(self):
        super().__init__()
        self.params: Optional[Dict[str, np.ndarray]] = None
        self.labels: Optional[np.ndarray] = None

    def transform(self, *inputs, device=None):
        """prediction (DOUBLE) and the class probabilities (a DOUBLE vector
        column, ``rawPrediction``) for the token-id rows of the features
        column, on ``device`` (None → the GPU)."""
        (df,) = inputs
        if self.params is None:
            raise RuntimeError("model must be fit/loaded before transform")
        tok = np.asarray(df.vectors(self.get_features_col()), np.int32)
        vocab = int(self.params["emb"].shape[0])
        if tok.size and (tok.min() < 0 or tok.max() >= vocab):
            # an out-of-range id would index another row of the embedding
            # (negative) or fail deep inside the gather
            raise ValueError(
                f"token ids must be in [0, {vocab}); got "
                f"[{tok.min()}, {tok.max()}]"
            )
        ctx = sequence_mesh(device)
        dev = resolve_device(device) if ctx is None else ctx.device
        n_heads = self.get_num_heads()
        params = {name: torch.tensor(np.asarray(a, np.float32), device=dev) for name, a in self.params.items()}
        tok, t_real = _pad_tokens(tok, _n_shards(ctx))
        tok_t = torch.from_numpy(_local_tokens(tok, ctx)).to(dev).long()
        with torch.no_grad():
            logits = _forward(params, tok_t, t_real, n_heads, ctx)
            probs = torch.softmax(logits, dim=-1)
            pred_idx = torch.argmax(logits, dim=-1)
        pred = np.asarray(self.labels)[pred_idx.cpu().numpy()]
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, np.asarray(pred, np.float64))
        out.add_column(
            self.get_raw_prediction_col(),
            DataTypes.vector(BasicType.DOUBLE),
            probs.cpu().numpy().astype(np.float64),
        )
        return out

    # --- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        rw.save_metadata(self, path)
        rw.save_model_arrays(path, {"labels": self.labels, **self.params})

    @classmethod
    def load(cls, path: str):
        """Load a directory saved by this class or by its JAX twin."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        model = cls()
        model.load_param_map_from_json(metadata["paramMap"])
        arrays = rw.load_model_arrays(path)
        model.labels = arrays.pop("labels")
        model.params = dict(arrays)
        return model

    def get_model_data(self):
        """The JAX package's layout: one row of ``params`` (the dict of
        arrays) and ``labels``."""
        return [DataFrame(["params", "labels"], None, [[self.params], [self.labels]])]

    def set_model_data(self, *model_data):
        """Takes :meth:`get_model_data`'s layout, from either package."""
        df = model_data[0]
        self.params = {name: np.asarray(a, np.float32) for name, a in df.column("params")[0].items()}
        self.labels = np.asarray(df.column("labels")[0])
        return self


class SelfAttentionClassifier(Estimator, _AttnParams):
    """Adam training of the classifier on one device, or with the sequence
    split over a world of ranks."""

    def fit(self, *inputs, device=None) -> SelfAttentionClassifierModel:
        """Train on ``device`` (None → the GPU) from the JAX package's
        initial weights and window schedule. Records ``loss_history`` (each
        step's weighted loss) on the estimator."""
        (df,) = inputs
        emb, n_heads = self.get_embedding_dim(), self.get_num_heads()
        if emb % n_heads:
            raise ValueError(f"embeddingDim {emb} must divide evenly by numHeads {n_heads}")
        tok = np.asarray(df.vectors(self.get_features_col()), np.int32)
        if tok.min() < 0:
            raise ValueError("token ids must be non-negative")
        label_col = np.asarray(df.scalars(self.get_label_col()))
        labels = np.unique(label_col)
        y_idx = np.searchsorted(labels, label_col)
        vocab = self.get_vocab_size() or int(tok.max()) + 1
        if tok.max() >= vocab:
            raise ValueError(f"token id {tok.max()} >= vocabSize {vocab}")

        ctx = sequence_mesh(device)
        dev = resolve_device(device) if ctx is None else ctx.device
        n_shards = _n_shards(ctx)
        tok, t_real = _pad_tokens(tok, n_shards)
        n = tok.shape[0]
        batch = min(self.get_global_batch_size(), n)
        if dev.type == "cuda" and not _use_flash_train(tok, emb, n_heads, batch, dev, n_shards):
            raise ValueError(f"the fold's kernels hold head dims up to {MAX_HEAD_DIM}, got {emb // n_heads}")
        init = _init_params(np.random.default_rng(self.get_seed()), vocab, emb, len(labels))
        params = {name: torch.from_numpy(a).to(dev) for name, a in init.items()}
        mu = {name: torch.zeros_like(p) for name, p in params.items()}
        nu = {name: torch.zeros_like(p) for name, p in params.items()}
        tok_dev = torch.from_numpy(_local_tokens(tok, ctx)).to(dev).long()
        y_dev = torch.from_numpy(y_idx).to(dev)
        lr = self.get_learning_rate()
        offset = 0
        windows = {}  # (lo, offset) -> device tensors; the cycle is short
        losses = []
        for t in range(1, self.get_max_iter() + 1):
            # contiguous example window per step, cycling like the JAX fit;
            # at the clamped tail, rows before the logical offset are re-reads
            # and get zero weight. Windows are built once per (lo, offset).
            lo = min(offset, n - batch)
            key = (lo, offset)
            if key not in windows:
                weight = (np.arange(batch) + lo >= offset).astype(np.float32)
                windows[key] = (tok_dev[lo:lo + batch], y_dev[lo:lo + batch], torch.from_numpy(weight).to(dev))
            tok_w, y_w, w_w = windows[key]
            params, mu, nu, loss = _train_step(params, mu, nu, t, tok_w, y_w, w_w, t_real, n_heads, lr, ctx)
            losses.append(loss)
            offset = 0 if offset + batch >= n else offset + batch
        self.loss_history = torch.stack(losses).cpu().tolist() if losses else []

        model = SelfAttentionClassifierModel()
        update_existing_params(model, self)
        model.set_vocab_size(vocab)
        model.params = {name: p.cpu().numpy() for name, p in params.items()}
        model.labels = labels.astype(np.float64)
        return model
