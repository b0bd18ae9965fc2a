"""The port's ``CheckpointManager`` on the CPU: the JAX package's checkpoint
contract (``tests/test_checkpoint.py``) — round trip and prune, atomic save,
orphan sweep, unparsable names, typed errors, quarantine and fallback on a
corrupt snapshot or META, fingerprints — and, for the same SGD host-loop
fit, the same snapshots as the JAX package's manager writes.

Tolerances: every restored leaf is exact (the bytes round-trip); the
coefficient leaf of the two packages' fits is held within 1e-6 absolute
(float32 SGD rounding in another order), the offset leaf exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.checkpoint import CheckpointManager as JCheckpointManager
from flink_ml_tpu.metrics import MLMetrics as JMLMetrics
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops import LeastSquareLoss as JLeastSquareLoss
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context

from flink_ml_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    CheckpointManager,
    FingerprintMismatchError,
    scan_numbered_dirs,
)
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.ops.lossfunc import BinaryLogisticLoss, LeastSquareLoss
from flink_ml_tpu_torch.ops.optimizer import SGD

torch.set_num_threads(1)


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


def _corrupt_arrays(ckpt_dir):
    """Flip bytes inside arrays.npz (bit rot) without truncating it."""
    path = os.path.join(ckpt_dir, "arrays.npz")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    blob[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(blob)


def test_metric_names_equal_the_jax_package():
    for name in ("CHECKPOINT_GROUP", "CHECKPOINT_QUARANTINED", "CHECKPOINT_FALLBACKS",
                 "CHECKPOINT_TMP_SWEPT", "SERVING_SWAP_FAILURES", "SERVING_POLL_ERRORS"):
        assert getattr(MLMetrics, name) == getattr(JMLMetrics, name)


def test_round_trip_and_prune(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.restore_latest() is None
    state = [np.arange(4.0), {"nested": np.ones((2, 2)), "n": np.asarray(3)},
             (torch.arange(5, dtype=torch.float32), None)]
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.all_steps() == [2, 3]
    step, restored = mgr.restore_latest()
    assert step == 3
    np.testing.assert_array_equal(restored[0], state[0])
    np.testing.assert_array_equal(restored[1]["nested"], state[1]["nested"])
    assert int(restored[1]["n"]) == 3
    tensor, none = restored[2]
    assert isinstance(restored[2], tuple) and none is None
    assert isinstance(tensor, torch.Tensor) and tensor.dtype == torch.float32
    assert torch.equal(tensor, state[2][0])
    meta = json.load(open(tmp_path / "ckpt-3" / "META.json"))
    assert (meta["step"], meta["num_leaves"], len(meta["crc32s"])) == (3, 4, 4)
    with np.load(tmp_path / "ckpt-3" / "arrays.npz") as z:
        assert sorted(z.files) == ["leaf_0", "leaf_1", "leaf_2", "leaf_3"]
        np.testing.assert_array_equal(z["leaf_1"], 3)  # dict leaves in sorted key order: "n" first


def test_save_is_atomic_against_partial_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, [np.ones(2)])
    os.makedirs(str(tmp_path / "ckpt-2.tmp"))
    assert mgr.all_steps() == [1]
    assert mgr.restore_latest()[0] == 1
    mgr.save(2, [np.zeros(2)])
    assert mgr.all_steps() == [1, 2]


def test_fingerprint_mismatch_refuses_restore(tmp_path):
    CheckpointManager(str(tmp_path), fingerprint="run-a").save(5, [np.arange(3.0)])
    assert CheckpointManager(str(tmp_path), fingerprint="run-a").restore_latest()[0] == 5
    with pytest.raises(ValueError, match="different\\s+run"):
        CheckpointManager(str(tmp_path), fingerprint="run-b").restore_latest()
    assert CheckpointManager(str(tmp_path)).restore_latest()[0] == 5


def test_all_steps_skips_unparsable_entries(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, [np.ones(2)])
    mgr.save(2, [np.ones(2)])
    os.makedirs(str(tmp_path / "ckpt-3.corrupt"))
    (tmp_path / "ckpt-3.corrupt" / "META.json").write_text("{}")
    (tmp_path / "ckpt-stray.txt").write_text("not a checkpoint")
    os.makedirs(str(tmp_path / "ckpt-notanumber"))
    assert mgr.all_steps() == [1, 2]
    assert scan_numbered_dirs(str(tmp_path / "missing")) == []
    assert mgr.restore_latest()[0] == 2


def test_orphan_tmp_swept_on_construction(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, [np.ones(2)])
    os.makedirs(str(tmp_path / "ckpt-2.tmp"))
    (tmp_path / "ckpt-2.tmp" / "arrays.npz").write_bytes(b"partial")
    swept0 = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_TMP_SWEPT, 0)
    mgr2 = CheckpointManager(str(tmp_path))
    assert not os.path.exists(str(tmp_path / "ckpt-2.tmp"))
    assert mgr2.all_steps() == [1]
    assert metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_TMP_SWEPT) == swept0 + 1


def test_restore_missing_step_raises_typed_error(tmp_path):
    with pytest.raises(CheckpointCorruptError) as e:
        CheckpointManager(str(tmp_path)).restore(7)
    assert e.value.step == 7 and "ckpt-7" in e.value.path


@pytest.mark.parametrize("lost", ["arrays.npz", "tree.json"])
def test_restore_truncated_snapshot_raises_typed_error(tmp_path, lost):
    mgr = CheckpointManager(str(tmp_path))
    os.remove(os.path.join(mgr.save(1, [np.arange(4.0)]), lost))
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        mgr.restore(1)


def test_corrupt_newest_quarantined_and_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    state1, state2 = [torch.arange(4.0)], [torch.arange(4.0) * 2]
    mgr.save(1, state1)
    _corrupt_arrays(mgr.save(2, state2))
    q0 = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_QUARANTINED, 0)
    f0 = metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_FALLBACKS, 0)
    step, state = mgr.restore_latest()
    assert step == 1 and torch.equal(state[0], state1[0])
    assert os.path.isdir(str(tmp_path / "ckpt-2.corrupt"))
    assert not os.path.exists(str(tmp_path / "ckpt-2"))
    assert metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_QUARANTINED) == q0 + 1
    assert metrics.get(MLMetrics.CHECKPOINT_GROUP, MLMetrics.CHECKPOINT_FALLBACKS) == f0 + 1


def test_a_second_quarantine_of_one_step_is_numbered(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, [np.ones(3)])
    for _ in range(2):
        _corrupt_arrays(mgr.save(2, [np.ones(3)]))
        assert mgr.restore_latest()[0] == 1
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt-2")) == [
        "ckpt-2.corrupt", "ckpt-2.corrupt.1"]


def test_all_snapshots_corrupt_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    _corrupt_arrays(mgr.save(1, [np.ones(3)]))
    _corrupt_arrays(mgr.save(2, [np.ones(3)]))
    assert mgr.restore_latest() is None


def test_fingerprint_mismatch_is_typed_and_does_not_fall_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), fingerprint="run-a")
    mgr.save(1, [np.ones(2)])
    mgr.save(2, [np.ones(2)])
    other = CheckpointManager(str(tmp_path), fingerprint="run-b")
    with pytest.raises(FingerprintMismatchError):
        other.restore_latest()
    assert other.all_steps() == [1, 2]


def test_meta_corruption_falls_back_too(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=3)
    mgr.save(1, [np.ones(2)])
    d2 = mgr.save(2, [np.ones(2)])
    with open(os.path.join(d2, "META.json"), "w") as f:
        f.write('{"step": 2, "num_le')  # truncated mid-write
    assert mgr.restore_latest()[0] == 1


def test_restore_places_tensor_leaves_on_the_named_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"coef": torch.ones(3, dtype=torch.float64), "offset": np.asarray(7, np.int32)})
    _, state = mgr.restore_latest(device="cpu")
    assert state["coef"].dtype == torch.float64 and state["coef"].device.type == "cpu"
    assert isinstance(state["offset"], np.ndarray) and state["offset"].dtype == np.int32
    with pytest.raises(TypeError, match="string keys"):
        mgr.save(2, {1: np.ones(1)})


# ---------------------------------------------------------------------------
# SGD's fingerprints and snapshots against the JAX package
# ---------------------------------------------------------------------------


def _logistic_data(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    return {"features": X, "labels": (rng.random(64) > 0.5).astype(np.float32)}


def test_sgd_installs_its_config_fingerprint(tmp_path):
    data = _logistic_data()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    SGD(max_iter=3, global_batch_size=32, checkpoint_manager=mgr, checkpoint_interval=1,
        device="cpu").optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)
    assert mgr.fingerprint is not None
    mgr2 = CheckpointManager(str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="different\\s+run"):
        SGD(max_iter=9, global_batch_size=32, checkpoint_manager=mgr2, checkpoint_interval=1,
            device="cpu").optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)


def test_reused_manager_across_configs_refuses(tmp_path):
    data = _logistic_data(4)
    mgr = CheckpointManager(str(tmp_path))
    SGD(max_iter=3, global_batch_size=32, checkpoint_manager=mgr, checkpoint_interval=1,
        device="cpu").optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)
    with pytest.raises(ValueError, match="different\\s+run"):
        SGD(max_iter=9, global_batch_size=32, checkpoint_manager=mgr, checkpoint_interval=1,
            device="cpu").optimize(np.zeros(4), data, BinaryLogisticLoss.INSTANCE)


@pytest.mark.parametrize("loss_name,layout", [
    ("logistic", "dense"), ("least_square", "dense"), ("logistic", "sparse"),
])
def test_both_packages_write_the_same_snapshots_for_the_same_fit(tmp_path, one_device_mesh, loss_name, layout):
    losses = {"logistic": (BinaryLogisticLoss.INSTANCE, JBinaryLogisticLoss.INSTANCE),
              "least_square": (LeastSquareLoss.INSTANCE, JLeastSquareLoss.INSTANCE)}
    loss, jloss = losses[loss_name]
    data = _logistic_data(7)
    dim = 4
    if layout == "sparse":
        rng = np.random.default_rng(8)
        dim = 30
        data = {"indices": rng.integers(0, dim, size=(64, 5)).astype(np.int32),
                "values": rng.normal(size=(64, 5)).astype(np.float32), "labels": data["labels"]}
    kw = dict(max_iter=12, learning_rate=0.1, global_batch_size=24, tol=0.0, reg=0.01)
    port_mgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=3)
    jax_mgr = JCheckpointManager(str(tmp_path / "jax"), max_to_keep=3)
    coef = SGD(checkpoint_manager=port_mgr, checkpoint_interval=3, device="cpu", **kw).optimize(
        np.zeros(dim), data, loss)
    jcoef = JSGD(checkpoint_manager=jax_mgr, checkpoint_interval=3, **kw).optimize(np.zeros(dim), data, jloss)
    np.testing.assert_allclose(coef, jcoef, rtol=0, atol=1e-6)
    assert port_mgr.fingerprint == jax_mgr.fingerprint
    assert port_mgr.all_steps() == jax_mgr.all_steps() == [3, 6, 9]
    for step in port_mgr.all_steps():
        metas = [json.load(open(os.path.join(m.directory, f"ckpt-{step}", "META.json")))
                 for m in (port_mgr, jax_mgr)]
        assert [(m["step"], m["num_leaves"], m["fingerprint"]) for m in metas] == [
            (step, 2, port_mgr.fingerprint)] * 2
        with np.load(os.path.join(port_mgr.directory, f"ckpt-{step}", "arrays.npz")) as z, \
                np.load(os.path.join(jax_mgr.directory, f"ckpt-{step}", "arrays.npz")) as jz:
            assert sorted(z.files) == sorted(jz.files) == ["leaf_0", "leaf_1"]
            for name in z.files:
                assert (z[name].shape, z[name].dtype) == (jz[name].shape, jz[name].dtype)
            np.testing.assert_array_equal(z["leaf_1"], jz["leaf_1"])
            np.testing.assert_allclose(z["leaf_0"], jz["leaf_0"], rtol=0, atol=1e-6)
