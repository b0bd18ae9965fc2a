"""The port's mesh pieces against the JAX package on the CPU, in one
process: the deterministic tier's folds, the quanta and the block-cyclic
deal, a rank's share of the training rows (``ShardedTrainCache``,
``DeviceDataCache`` on a mesh) and of the one-hot layout, the resolution of
``train.mesh``, the transport rule, and ``ShardedCheckpointManager``
snapshots read across both packages. A rank's view is a ``MeshContext``
made without a process group (``_rank``); the collectives themselves run in
the spawned worlds of ``test_torch_sharded_training.py``.

Every comparison here is exact: the folds are elementwise float adds in an
order both packages fix, and the rest is integer arithmetic and copies.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.checkpoint import (
    MeshMismatchError as JMeshMismatchError,
    ShardedCheckpointManager as JShardedCheckpointManager,
)
from flink_ml_tpu.iteration.datacache import DeviceDataCache as JDeviceDataCache
from flink_ml_tpu.linalg.onehot_sparse import OneHotSparseLayout as JOneHotSparseLayout
from flink_ml_tpu.parallel import (
    MeshContext as JMeshContext,
    TrainSharding as JTrainSharding,
    block_partials as jblock_partials,
    mapreduce_sum as jmapreduce_sum,
    tree_fold_sum as jtree_fold_sum,
)

from flink_ml_tpu_torch.checkpoint import (
    CheckpointManager,
    MeshMismatchError,
    ShardedCheckpointManager,
    ShardedLeaf,
)
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.iteration.datacache import DeviceDataCache
from flink_ml_tpu_torch.linalg.onehot_sparse import OneHotSparseLayout
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss
from flink_ml_tpu_torch.ops.optimizer import SGD
from flink_ml_tpu_torch.parallel import (
    BLOCK_ROWS,
    MeshContext,
    TrainSharding,
    block_partials,
    mapreduce_sum,
    pick_backend,
    resolve_train_sharding,
    row_fold_sum,
    tree_fold_sum,
)
from flink_ml_tpu_torch.parallel.collectives import rowwise

torch.set_num_threads(1)

WIDTHS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for opt in (Options.TRAIN_MESH, Options.TRAIN_MESH_MODEL, Options.TRAIN_MESH_HOSTS):
        config.unset(opt)


def _rank(n_data, rank):
    """Rank ``rank``'s MeshContext of a width-``n_data`` mesh on the CPU,
    made without a process group."""
    ctx = MeshContext.__new__(MeshContext)
    ctx.__dict__.update(group=None, distributed=False, n_data=n_data, n_model=1, rank=rank,
                        backend=None, device=torch.device("cpu"))
    return ctx


def _jax_shards(arr):
    """A JAX array's per-device pieces along the data axis, in device order."""
    return [np.asarray(s.data) for s in sorted(arr.addressable_shards, key=lambda s: s.index[0].start or 0)]


# ---------------------------------------------------------------------------
# the deterministic folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, trailing", [(8, ()), (64, (3,)), (200, (2, 5)), (1024, (7,))])
def test_block_partials_and_the_folds_are_bit_equal_to_jax(rows, trailing):
    rng = np.random.default_rng(rows)
    x = (rng.normal(size=(rows,) + trailing) * 10.0 ** rng.integers(-3, 4, size=(rows,) + trailing)).astype(np.float32)
    np.testing.assert_array_equal(block_partials(torch.from_numpy(x)).numpy(), np.asarray(jblock_partials(x)))
    blocks = x[: rows // 2]
    np.testing.assert_array_equal(tree_fold_sum(torch.from_numpy(blocks)).numpy(),
                                  np.asarray(jtree_fold_sum(jnp.asarray(blocks))))
    np.testing.assert_array_equal(mapreduce_sum(torch.from_numpy(x)).numpy(), np.asarray(jmapreduce_sum(x)))


def test_trailing_zero_blocks_are_inert():
    """A wider mesh pads the same rows to a larger quantum: zero blocks at
    the end never change the fold, in either package."""
    rng = np.random.default_rng(1)
    blocks = rng.normal(size=(5, 4)).astype(np.float32)
    base = tree_fold_sum(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(base, np.asarray(jtree_fold_sum(jnp.asarray(blocks))))
    for pad in (1, 3, 11):
        padded = np.concatenate([blocks, np.zeros((pad, 4), np.float32)])
        np.testing.assert_array_equal(tree_fold_sum(torch.from_numpy(padded)).numpy(), base)


def test_block_partials_rejects_a_ragged_batch():
    with pytest.raises(ValueError, match="rows % 8"):
        block_partials(torch.zeros(12, 2))


@pytest.mark.parametrize("d", [1, 2, 5, 100, 129])
def test_row_fold_sum_is_the_pairwise_fold_whatever_the_row_count(d):
    rng = np.random.default_rng(d)
    t = rng.normal(size=(37, d)).astype(np.float32)
    want = np.stack([tree_fold_sum(torch.from_numpy(row)[:, None]).numpy()[0] for row in t])
    got = row_fold_sum(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    for rows in (1, 8, 23):
        np.testing.assert_array_equal(row_fold_sum(torch.from_numpy(t[:rows])).numpy(), got[:rows])


def test_rowwise_gives_a_row_the_same_bits_whatever_the_row_count():
    """The logistic loss's exp and log rounded alike for a row whether it
    falls in the CPU's vector lanes or in the scalar tail of a shorter call."""
    rng = np.random.default_rng(2)
    dot, y = (torch.from_numpy(rng.normal(size=70000).astype(np.float32) * 8) for _ in range(2))
    y, w = (y > 0).float(), torch.ones(70000)
    fn = BinaryLogisticLoss.INSTANCE.row_loss_and_mult
    full = rowwise(fn, dot, y, w)
    for n in (1, 5, 16, 33, 100, 40000):
        part = rowwise(fn, dot[:n], y[:n], w[:n])
        for a, b in zip(part, full):
            np.testing.assert_array_equal(a.numpy(), b[:n].numpy())


# ---------------------------------------------------------------------------
# quanta, the deal, a rank's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_quanta_and_the_deal_equal_jax(width):
    ts, jts = TrainSharding(width), JTrainSharding(width)
    assert ts.row_quantum == jts.row_quantum == BLOCK_ROWS * width
    assert ts.key == jts.key
    for b in (1, 7, 8, 33, 64, 100, 65536):
        assert ts.round_batch(b) == jts.round_batch(b)
        B = ts.round_batch(b)
        for n in (1, 99, 300, 100_000):
            assert ts.padded_rows(n, B) == jts.padded_rows(n, B)
    for n_padded in (ts.row_quantum, ts.row_quantum * 5, 1024):
        np.testing.assert_array_equal(ts.deal_permutation(n_padded), jts.deal_permutation(n_padded))
    with pytest.raises(ValueError, match="quantum"):
        ts.padded_rows(100, ts.row_quantum + 1)


@pytest.mark.parametrize("width", [2, 4, 8])
def test_each_rank_holds_the_jax_devices_share(width):
    """Rank k's ShardedTrainCache rows and mask equal device k's shard of
    the JAX cache, as do DeviceDataCache's contiguous shares."""
    rng = np.random.default_rng(width)
    n = 299
    cols = {"x": rng.normal(size=(n, 3)).astype(np.float32), "y": rng.normal(size=n).astype(np.float32)}
    jcache = JTrainSharding(width).deal_cache(cols, global_batch=64)
    jdev = JDeviceDataCache(cols, ctx=JMeshContext(n_data=width, n_model=1))
    for k in range(width):
        cache = TrainSharding(width, ctx=_rank(width, k)).deal_cache(cols, global_batch=64)
        assert (cache.n_valid, cache.n_padded, cache.local_rows, cache.local_batch) == (
            jcache.n_valid, jcache.n_padded, jcache.local_rows, jcache.local_batch)
        for name in ("x", "y", "__mask__"):
            np.testing.assert_array_equal(cache.arrays[name].numpy(), _jax_shards(jcache.arrays[name])[k])
        dev = DeviceDataCache(cols, ctx=_rank(width, k))
        assert (dev.n_valid, dev.n_padded, dev.local_rows) == (jdev.n_valid, jdev.n_padded, jdev.local_rows)
        for name in ("x", "y", "__mask__"):
            np.testing.assert_array_equal(dev.arrays[name].numpy(), _jax_shards(jdev.arrays[name])[k])


def test_the_deal_rejects_ragged_columns():
    with pytest.raises(ValueError, match="inconsistent"):
        TrainSharding(2, ctx=_rank(2, 0)).deal_cache({"a": np.zeros(8), "b": np.zeros(9)})


@pytest.mark.parametrize("width", [1, 2, 4])
def test_every_rank_builds_the_jax_plan_and_its_share_of_the_stacks(width):
    rng = np.random.default_rng(5)
    n, K, d = 1000, 6, 1 << 14
    idx = rng.integers(0, d, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.3] = 0.0
    local_batch = -(-300 // width)
    jlay = JOneHotSparseLayout.build(idx, val, d, width, local_batch, sub_rows=64)
    for k in range(width):
        lay = OneHotSparseLayout.build(idx, val, d, local_batch, sub_rows=64, n_shards=width, shard=k)
        assert lay.class_meta == jlay.class_meta and lay.n_flat == jlay.n_flat
        np.testing.assert_array_equal(lay.perm, jlay.perm)
        assert lay.window_starts == jlay.window_starts and lay.local_batch == jlay.local_batch
        for name in ("lidx", "rowid", "lvals"):
            np.testing.assert_array_equal(getattr(lay, name), getattr(jlay, name)[k, 0], err_msg=name)


# ---------------------------------------------------------------------------
# resolution, transport, entry-point errors
# ---------------------------------------------------------------------------


def test_resolution_of_train_mesh():
    assert resolve_train_sharding("cpu") is None  # unset: the single-device paths
    config.set(Options.TRAIN_MESH, 0)
    assert resolve_train_sharding("cpu") is None  # 0: explicit off
    config.set(Options.TRAIN_MESH, 1)
    ts = resolve_train_sharding("cpu")  # the width-1 program, with no process group
    assert ts.key == (1, 1) and ts.ctx.n_data == 1 and not ts.ctx.distributed
    assert ts.ctx.device == torch.device("cpu") and ts.ctx.rank == 0
    config.set(Options.TRAIN_MESH, 4)
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        resolve_train_sharding("cpu")
    config.set(Options.TRAIN_MESH_MODEL, 2)  # tensor parallelism: train.mesh x train.mesh.model ranks
    with pytest.raises(ValueError, match="process group of 8 ranks"):
        resolve_train_sharding("cpu")
    config.unset(Options.TRAIN_MESH_MODEL)
    config.set(Options.TRAIN_MESH, 1)
    config.set(Options.TRAIN_MESH_HOSTS, 2)
    with pytest.raises(ValueError, match="torchrun"):
        resolve_train_sharding("cpu")


def test_the_transport_rule(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert pick_backend(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pick_backend(4, "cuda") == "nccl"  # a card a rank
    assert pick_backend(8, None) == "gloo"  # ranks share cards: NCCL refuses them
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")  # two hosts of two ranks
    assert pick_backend(4, "cuda") == "nccl"


def test_the_process_global_mesh_and_its_block():
    from flink_ml_tpu_torch.parallel import get_mesh_context, mesh_context, set_mesh_context

    outer, inner = _rank(1, 0), _rank(2, 1)
    set_mesh_context(outer)
    try:
        assert get_mesh_context() is outer
        with mesh_context(inner) as ctx:
            assert ctx is inner and get_mesh_context() is inner
            assert inner.local_range(5) == (3, 5, 3)  # rank 1 of 2: rows [3, 5), padded to 3
        assert get_mesh_context() is outer
    finally:
        set_mesh_context(None)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        MeshContext(n_model=2)  # a model axis of 2 needs a world of 2


def test_sgd_takes_ctx_or_sharding_not_both():
    with pytest.raises(ValueError, match="not both"):
        SGD(ctx=_rank(1, 0), sharding=TrainSharding(1))


def test_width_one_sharding_is_the_deterministic_program():
    """An explicit width-1 TrainSharding runs the deterministic tier: the
    same coefficient as ``train.mesh = 1`` and every epoch's schedule."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    data = {"features": X, "labels": (X[:, 0] > 0).astype(np.float32)}
    kw = dict(max_iter=7, global_batch_size=20, tol=0.0, device="cpu")
    a = SGD(sharding=TrainSharding(1, device="cpu"), **kw).optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)
    config.set(Options.TRAIN_MESH, 1)
    b = SGD(**kw).optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# ShardedCheckpointManager across both packages
# ---------------------------------------------------------------------------


def _jax_state(jts):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 6)).astype(np.float32)
    cent = rng.normal(size=(4, 3)).astype(np.float32)
    return {"w": jax.device_put(w, jts.ctx.sharding(None, "model")), "cent": jts.replicate(cent),
            "epoch": np.int64(7)}, w, cent


def test_the_port_reads_a_jax_snapshot_with_pieces(tmp_path):
    jts = JTrainSharding(4, 2)
    state, w, cent = _jax_state(jts)
    JShardedCheckpointManager(str(tmp_path), sharding=jts, fingerprint="fp").save(3, state)
    step, got = ShardedCheckpointManager(str(tmp_path), sharding=(4, 2), fingerprint="fp").restore_latest()
    assert step == 3 and sorted(got) == ["cent", "epoch", "w"]
    np.testing.assert_array_equal(got["w"], w)
    np.testing.assert_array_equal(got["cent"], cent)
    assert int(got["epoch"]) == 7
    with pytest.raises(MeshMismatchError):
        ShardedCheckpointManager(str(tmp_path), sharding=(2, 4)).restore_latest()


def test_jax_reads_a_port_snapshot_with_pieces(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 6)).astype(np.float32)
    leaf = ShardedLeaf((16, 6), [(((0, 16), (0, 3)), torch.from_numpy(w[:, :3])),
                                 (((0, 16), (3, 6)), w[:, 3:])])
    state = {"w": leaf, "coef": torch.arange(5.0), "h": [np.int64(4), None, (np.float32(1.5),)]}
    mgr = ShardedCheckpointManager(str(tmp_path), sharding=(4, 2), fingerprint="fp")
    mgr.save(2, state)
    meta = json.load(open(tmp_path / "ckpt-2" / "META.json"))
    assert meta["format"] == "sharded-v1" and meta["mesh"] == [4, 2]
    assert [len(d["pieces"]) for d in meta["leaves"] if d is not None] == [2]
    jstep, jgot = JShardedCheckpointManager(str(tmp_path), sharding=(4, 2), fingerprint="fp").restore_latest()
    assert jstep == 2
    np.testing.assert_array_equal(np.asarray(jgot["w"]), w)
    np.testing.assert_array_equal(np.asarray(jgot["coef"]), np.arange(5.0, dtype=np.float32))
    assert int(jgot["h"][0]) == 4 and jgot["h"][1] is None and float(jgot["h"][2][0]) == 1.5
    with pytest.raises(JMeshMismatchError):
        JShardedCheckpointManager(str(tmp_path), sharding=(8, 1)).restore_latest()
    step, got = mgr.restore_latest()  # the port reads its own: tensors come back as tensors
    assert step == 2 and isinstance(got["w"], torch.Tensor) and isinstance(got["coef"], torch.Tensor)
    np.testing.assert_array_equal(got["w"].numpy(), w)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_replicated_snapshot_restores_at_another_width(tmp_path, writer):
    cent = np.arange(12, dtype=np.float32).reshape(4, 3)
    if writer == "port":
        ShardedCheckpointManager(str(tmp_path), sharding=(2, 1), fingerprint="fp").save(
            1, {"cent": torch.from_numpy(cent), "epoch": np.int64(2)})
    else:
        jts = JTrainSharding(2)
        JShardedCheckpointManager(str(tmp_path), sharding=jts, fingerprint="fp").save(
            1, {"cent": jts.replicate(cent), "epoch": np.int64(2)})
    for mgr in (ShardedCheckpointManager(str(tmp_path), sharding=(8, 1), fingerprint="fp"),
                JShardedCheckpointManager(str(tmp_path), sharding=(8, 1), fingerprint="fp")):
        step, got = mgr.restore_latest()
        assert step == 1
        np.testing.assert_array_equal(np.asarray(got["cent"]), cent)
        assert int(got["epoch"]) == 2


def test_a_corrupt_piece_is_quarantined_and_the_older_snapshot_restored(tmp_path):
    leaf = ShardedLeaf((4, 2), [(((0, 2), (0, 2)), np.ones((2, 2), np.float32)),
                                (((2, 4), (0, 2)), np.zeros((2, 2), np.float32))])
    mgr = ShardedCheckpointManager(str(tmp_path), sharding=(2, 1), fingerprint="fp")
    mgr.save(1, {"w": leaf})
    mgr.save(2, {"w": leaf})
    npz = tmp_path / "ckpt-2" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    step, got = mgr.restore_latest()
    assert step == 1 and (tmp_path / "ckpt-2.corrupt").exists()
    np.testing.assert_array_equal(got["w"], np.concatenate([np.ones((2, 2)), np.zeros((2, 2))]))


def test_the_sharded_manager_reads_a_plain_snapshot(tmp_path):
    CheckpointManager(str(tmp_path), fingerprint="fp").save(9, {"a": np.ones(3)})
    step, got = ShardedCheckpointManager(str(tmp_path), sharding=(2, 1), fingerprint="fp").restore_latest()
    assert step == 9
    np.testing.assert_array_equal(got["a"], np.ones(3))
