"""Sequence-parallel primitives — twin of ``flink_ml_tpu/parallel/``: the
ring-attention fold (``flash.py``) and ring attention (``ring.py``), on one
shard."""
from flink_ml_tpu_torch.parallel.flash import (
    FLASH_FOLD,
    MAX_HEAD_DIM,
    TILE_K,
    TILE_Q,
    flash_available,
    fold_smem_bytes,
    fused_fold,
    reference_fold,
)
from flink_ml_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded

__all__ = [
    "FLASH_FOLD",
    "MAX_HEAD_DIM",
    "TILE_K",
    "TILE_Q",
    "flash_available",
    "fold_smem_bytes",
    "fused_fold",
    "reference_fold",
    "ring_attention",
    "ring_attention_sharded",
]
