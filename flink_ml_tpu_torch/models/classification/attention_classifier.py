"""Self-attention sequence classifier, the serving half — twin of
``flink_ml_tpu/models/classification/attention_classifier.py``.

Architecture, as in the JAX package: token embedding → one multi-head
self-attention block with a residual → masked mean-pool over the real
positions → softmax head. The q/k/v/o projections and the head are plain
matrix products (``torch.matmul``, as the JAX package leaves them to XLA);
the attention runs through ``parallel/ring.py`` on one shard, whose fold is
the CUDA kernel ``csrc/flash_fold.cu`` on the card and the plain fold on the
CPU. Parameters keep the JAX layout (``emb [vocab, E]``, ``wq``/``wk``/
``wv``/``wo [E, E]``, ``w_cls [E, C]``, ``b_cls [C]``), so model data
crosses between the packages unchanged.

Not ported yet: the ``SelfAttentionClassifier`` Estimator (``fit``), whose
training step needs the fold's backward kernels (ROADMAP.md Queue A 3).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators
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
from flink_ml_tpu_torch.parallel.ring import ring_attention
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["SelfAttentionClassifierModel"]


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


def _forward(params: Dict[str, torch.Tensor], tok: torch.Tensor, n_valid: int, n_heads: int) -> torch.Tensor:
    """Logits [B, C] for token ids ``tok`` [B, T] of real length ``n_valid``:
    keys at positions >= ``n_valid`` are masked out of the attention and the
    pool, as in the JAX package. On the card the fold is the kernel, which
    raises ``ValueError`` for a head dim past its limit."""
    B, T = tok.shape
    E = params["emb"].shape[1]
    h = params["emb"][tok]  # [B, T, E]
    q = (h @ params["wq"]).reshape(B, T, n_heads, E // n_heads)
    k = (h @ params["wk"]).reshape(B, T, n_heads, E // n_heads)
    v = (h @ params["wv"]).reshape(B, T, n_heads, E // n_heads)
    attn = ring_attention(q, k, v, causal=False, n_valid=n_valid)
    a = attn.reshape(B, T, E) @ params["wo"] + h  # residual
    valid = (torch.arange(T, device=tok.device) < n_valid).to(a.dtype)
    pooled = torch.sum(a * valid[None, :, None], dim=1) / float(n_valid)
    return pooled @ params["w_cls"] + params["b_cls"]


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
        dev = resolve_device(device)
        n_heads = self.get_num_heads()
        params = {name: torch.tensor(np.asarray(a, np.float32), device=dev) for name, a in self.params.items()}
        tok_t = torch.from_numpy(tok).to(dev).long()
        t_real = int(tok.shape[1])
        with torch.no_grad():
            logits = _forward(params, tok_t, t_real, n_heads)
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
