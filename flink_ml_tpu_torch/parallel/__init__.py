"""Distributed substrate — twin of ``flink_ml_tpu/parallel/``: the training
mesh of ``torch.distributed`` processes laid out ``[slice, data, model]``
with a process subgroup per axis (``mesh.py``), its collectives and the
deterministic mapreduce tier (``collectives.py``), the block-cyclic deal of
training rows (``train_sharding.py``), the ring-attention fold and its
backward (``flash.py``), ring attention with K/V blocks rotating between
ranks (``ring.py``), and expert-parallel mixture-of-experts over two
all-to-alls (``moe.py``)."""
from flink_ml_tpu_torch.parallel.collectives import (
    BLOCK_ROWS,
    all_reduce_mean,
    all_reduce_sum,
    block_partials,
    mapreduce_sum,
    psum_tree,
    row_fold_sum,
    tree_fold_sum,
)
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
from flink_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SLICE_AXIS,
    MeshContext,
    get_mesh_context,
    mesh_context,
    set_mesh_context,
)
from flink_ml_tpu_torch.parallel.moe import moe_ffn, moe_ffn_sharded
from flink_ml_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from flink_ml_tpu_torch.parallel.train_sharding import (
    ShardedTrainCache,
    TrainSharding,
    ensure_distributed,
    pick_backend,
    resolve_train_sharding,
)

__all__ = [
    "BLOCK_ROWS",
    "DATA_AXIS",
    "MODEL_AXIS",
    "SLICE_AXIS",
    "MeshContext",
    "ShardedTrainCache",
    "TrainSharding",
    "all_reduce_mean",
    "all_reduce_sum",
    "block_partials",
    "ensure_distributed",
    "get_mesh_context",
    "mapreduce_sum",
    "mesh_context",
    "moe_ffn",
    "moe_ffn_sharded",
    "pick_backend",
    "psum_tree",
    "resolve_train_sharding",
    "row_fold_sum",
    "set_mesh_context",
    "tree_fold_sum",
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
