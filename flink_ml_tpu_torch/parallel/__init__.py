"""Sequence-parallel primitives — twin of ``flink_ml_tpu/parallel/``: the
ring-attention fold and its backward (``flash.py``) and ring attention
(``ring.py``), on one shard."""
from flink_ml_tpu_torch.parallel.flash import (
    FLASH_FOLD,
    FLASH_FOLD_BWD_DKV,
    FLASH_FOLD_BWD_DQ,
    MAX_HEAD_DIM,
    TILE_K,
    TILE_Q,
    flash_available,
    flash_train_available,
    fold_bwd_dkv,
    fold_bwd_dq,
    fold_bwd_smem_bytes,
    fold_smem_bytes,
    fused_fold,
    fused_fold_bwd,
    reference_fold,
    reference_fold_bwd,
)
from flink_ml_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded

__all__ = [
    "FLASH_FOLD",
    "FLASH_FOLD_BWD_DKV",
    "FLASH_FOLD_BWD_DQ",
    "MAX_HEAD_DIM",
    "TILE_K",
    "TILE_Q",
    "flash_available",
    "flash_train_available",
    "fold_bwd_dkv",
    "fold_bwd_dq",
    "fold_bwd_smem_bytes",
    "fold_smem_bytes",
    "fused_fold",
    "fused_fold_bwd",
    "reference_fold",
    "reference_fold_bwd",
    "ring_attention",
    "ring_attention_sharded",
]
