"""The port's tensor parallelism (``train.mesh.model``, ``MeshContext(n_data,
n_model, n_slices)``) in gloo worlds of 2, 4 and 8 ranks on the CPU, against
the JAX package at the same mesh shape and against itself across model
widths.

Each world is spawned once for the module (``tests/torch_sharded_worker.py``)
with ``train.mesh`` × ``train.mesh.model`` set to 1 × 2, 2 × 2 and 4 × 2,
and runs every scenario of that world; scenarios with an explicit
``MeshContext`` cover 2 × 1, 4 × 1, 2 × 4 and 2 × 2 × 2 (two slices) in the
same worlds. The JAX side runs here on the conftest's 8 host devices under
``_jax_sharded`` (``test_torch_sharded_training.py``).

Tolerances, each with its source:
- every rank's model: bit-equal to rank 0's;
- dense TP against JAX at 4 × 2 and against the port's 4 × 1, d = 5: rtol
  1e-5 / atol 1e-6 (``tests/test_ops.py:240-275``);
- sparse scatter and one-hot TP against JAX at the same mesh: 1e-6 absolute
  (``SGD_ATOL``, float32 sums in another order);
- one-hot across ``n_model`` 1/2/4 at ``n_data`` 2: rtol 2e-3 / atol 1e-4,
  JAX's own invariance bound (``tests/test_onehot_sparse.py:543``);
- two slices against the flat mesh: rtol 1e-5 / atol 1e-6
  (``tests/test_onehot_sparse.py:539-541``);
- the plan and each rank's stacks: equal to JAX's, exactly;
- KMeans centroids 1e-5 and the MLP's parameters 1e-5
  (``test_torch_sharded_training.py``'s bounds);
- snapshots: the coefficient each package reads equal to the other's.
"""
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.checkpoint import ShardedCheckpointManager as JShardedCheckpointManager
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.onehot_sparse import OneHotSparseLayout as JOneHotSparseLayout
from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops.lossfunc import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.ops.lossfunc import LeastSquareLoss as JLeastSquareLoss
from flink_ml_tpu.parallel.mesh import MeshContext as JMeshContext

from flink_ml_tpu_torch.checkpoint import MeshMismatchError, ShardedCheckpointManager
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.linalg.onehot_sparse import OneHotSparseLayout

from tests.test_torch_sharded_training import _blobs, _jax_sharded
from tests.torch_sharded_worker import run_world

torch.set_num_threads(1)

DENSE_RTOL, DENSE_ATOL = 1e-5, 1e-6
SGD_ATOL = 1e-6
INV_RTOL, INV_ATOL = 2e-3, 1e-4
SLICE_RTOL, SLICE_ATOL = 1e-5, 1e-6
CENTROID_ATOL = 1e-5
MLP_ATOL = 1e-5

D_DENSE = 5  # not a multiple of n_model 2: the columns and the coefficient pad
DENSE_SGD = dict(max_iter=15, global_batch_size=32, tol=0.0, learning_rate=0.3, reg=0.01, elastic_net=0.5)
SPARSE_DIM = 600
SPARSE_SGD = dict(max_iter=10, global_batch_size=64, tol=0.0, learning_rate=0.4, reg=0.01, elastic_net=0.5)
LR = dict(iters=12, batch=64)
KMEANS = dict(k=3, seed=5, iters=9, measure="euclidean")
MLP = dict(hidden=8, iters=6, batch=64, seed=1)
CKPT_SGD = dict(max_iter=20, learning_rate=0.05, global_batch_size=32, tol=0.0)
CKPT_FAIL_AT = 12

#: world -> train.mesh × train.mesh.model
WORLDS = {2: (1, 2), 4: (2, 2), 8: (4, 2)}


def _dense():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(96, D_DENSE)).astype(np.float32)
    return X, (X[:, 0] > 0).astype(np.float32)


def _sparse():
    rng = np.random.default_rng(21)
    n, K = 256, 4
    return {"indices": rng.integers(0, SPARSE_DIM, size=(n, K)).astype(np.int32),
            "values": rng.normal(size=(n, K)).astype(np.float32),
            "labels": (rng.random(n) > 0.5).astype(np.float32)}


def _mesh_fits(mesh, kernels=("scatter", "onehot"), dense=True):
    """``sgd_on_mesh`` scenarios of one mesh shape ``(n_data, n_model,
    n_slices)``."""
    key = "x".join(map(str, mesh))
    X, y = _dense()
    out = []
    if dense:
        out.append((f"dense_{key}", "sgd_on_mesh", dict(data={"features": X, "labels": y}, dim=D_DENSE,
                                                        mesh=mesh, **DENSE_SGD)))
    out += [(f"{k}_{key}", "sgd_on_mesh", dict(data=_sparse(), dim=SPARSE_DIM, mesh=mesh, sparse_kernel=k,
                                               **SPARSE_SGD)) for k in kernels]
    return out


def _scenarios(world, tmp):
    X, y = _dense()
    out = [("lr", "logistic_regression", dict(features=X, labels=y, **LR))]
    if world == 2:
        out += _mesh_fits((2, 1, 1), ("onehot",), dense=False) + _mesh_fits((1, 2, 1))
    if world == 4:
        out += _mesh_fits((2, 2, 1)) + _mesh_fits((4, 1, 1), ())
        out.append(("mlp", "mlp", dict(features=X, labels=y, **MLP)))
        out.append(("groups", "groups_reused", dict(features=X, labels=y, **LR)))
        out.append(("kmeans", "kmeans", dict(points=_blobs(), **KMEANS)))
    if world == 8:
        out += _mesh_fits((4, 2, 1)) + _mesh_fits((2, 4, 1), ("onehot",), dense=False)
        out += _mesh_fits((2, 2, 2))
        out.append(("ckpt", "sgd_killed_and_resumed",
                    dict(data={"features": X, "labels": X @ np.ones(D_DENSE, np.float32)}, dim=D_DENSE,
                         ckpt_dir=os.path.join(tmp, "ckpt"), fail_at=CKPT_FAIL_AT, **CKPT_SGD)))
    return out


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for opt in (Options.TRAIN_MESH, Options.TRAIN_MESH_MODEL):
        config.unset(opt)
    for opt in (JOptions.TRAIN_MESH, JOptions.TRAIN_MESH_MODEL):
        jconfig.unset(opt)


@pytest.fixture(scope="module")
def tp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def worlds(tp_dir):
    """{world: {scenario: [rank 0's arrays, ...]}}, each world spawned once."""
    return {w: run_world(w, _scenarios(w, tp_dir), tp_dir, mesh=m, tag="tp") for w, m in WORLDS.items()}


def _fit(world, name):
    return world[name][0]


def _jax_fit(data, dim, mesh, loss=None, **kw):
    n_data, n_model, n_slices = mesh
    ctx = JMeshContext(devices=jax.devices()[:n_data * n_model * n_slices], n_data=n_data, n_model=n_model,
                       n_slices=n_slices)
    with _jax_sharded():
        return JSGD(ctx=ctx, **kw).optimize(np.zeros(dim, np.float32), data, loss or JBinaryLogisticLoss.INSTANCE)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_rank_returns_the_same_model(worlds, world):
    for name, ranks in worlds[world].items():
        assert len(ranks) == world, name
        for r in ranks[1:]:
            for key in ranks[0]:
                np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=f"{name}.{key}")


def test_dense_tp_matches_jax_and_the_data_parallel_mesh(worlds):
    X, y = _dense()
    got = _fit(worlds[8], "dense_4x2x1")["coef"]
    assert got.shape == (D_DENSE,)
    want = _jax_fit({"features": X, "labels": y}, D_DENSE, (4, 2, 1), **DENSE_SGD)
    np.testing.assert_allclose(got, want, rtol=DENSE_RTOL, atol=DENSE_ATOL)
    np.testing.assert_allclose(got, _fit(worlds[4], "dense_4x1x1")["coef"], rtol=DENSE_RTOL, atol=DENSE_ATOL)
    # 1 x 2 and 2 x 2 as well
    for world, mesh in ((2, (1, 2, 1)), (4, (2, 2, 1))):
        want = _jax_fit({"features": X, "labels": y}, D_DENSE, mesh, **DENSE_SGD)
        got = _fit(worlds[world], "dense_" + "x".join(map(str, mesh)))["coef"]
        np.testing.assert_allclose(got, want, rtol=DENSE_RTOL, atol=DENSE_ATOL)


@pytest.mark.parametrize("kernel", ["scatter", "onehot"])
@pytest.mark.parametrize("world, mesh", [(2, (1, 2, 1)), (4, (2, 2, 1)), (8, (4, 2, 1))])
def test_sparse_tp_matches_jax_at_the_same_mesh(worlds, kernel, world, mesh):
    got = _fit(worlds[world], f"{kernel}_" + "x".join(map(str, mesh)))
    want = _jax_fit(_sparse(), SPARSE_DIM, mesh, sparse_kernel=kernel, **SPARSE_SGD)
    np.testing.assert_allclose(got["coef"], want, rtol=0, atol=SGD_ATOL)


def test_onehot_is_invariant_in_the_model_width(worlds):
    base = _fit(worlds[2], "onehot_2x1x1")["coef"]
    for world, key in ((4, "onehot_2x2x1"), (8, "onehot_2x4x1")):
        np.testing.assert_allclose(_fit(worlds[world], key)["coef"], base, rtol=INV_RTOL, atol=INV_ATOL)


@pytest.mark.parametrize("kernel", ["dense", "scatter", "onehot"])
def test_two_slices_match_the_flat_mesh(worlds, kernel):
    flat = _fit(worlds[8], f"{kernel}_4x2x1")["coef"]
    hier = _fit(worlds[8], f"{kernel}_2x2x2")["coef"]
    np.testing.assert_allclose(hier, flat, rtol=SLICE_RTOL, atol=SLICE_ATOL)


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_the_plan_and_every_ranks_stacks_equal_jax(n_model):
    cols = _sparse()
    n_shards, local_batch = 2, 32
    want = JOneHotSparseLayout.build(cols["indices"], cols["values"], SPARSE_DIM, n_shards, local_batch,
                                     n_model=n_model)
    coef = np.random.default_rng(3).normal(size=SPARSE_DIM).astype(np.float32)
    for s in range(n_shards):
        for m in range(n_model):
            got = OneHotSparseLayout.build(cols["indices"], cols["values"], SPARSE_DIM, local_batch,
                                           n_shards=n_shards, shard=s, n_model=n_model, model_index=m)
            for name in ("owner_of_pos", "local_block_of_pos", "base_of_pos", "perm", "width_of_pos"):
                np.testing.assert_array_equal(getattr(got.plan, name), getattr(want.plan, name), err_msg=name)
            assert got.plan.class_meta == want.plan.class_meta
            assert (got.n_flat, got.nblk_local, got.n_model) == (want.n_flat, want.nblk_local, n_model)
            for name in ("lidx", "rowid", "lvals"):
                np.testing.assert_array_equal(getattr(got, name), getattr(want, name)[s, m], err_msg=name)
            np.testing.assert_array_equal(got.permute_coef(coef), want.permute_coef(coef))
            np.testing.assert_array_equal(got.unpermute_coef(want.permute_coef(coef)), coef)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_logistic_regression_on_a_tp_train_mesh_matches_jax(worlds, world):
    from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
    from flink_ml_tpu.models.classification.logistic_regression import LogisticRegression as JLogisticRegression

    X, y = _dense()
    n_data, n_model = WORLDS[world]
    jconfig.set(JOptions.TRAIN_MESH, n_data)
    jconfig.set(JOptions.TRAIN_MESH_MODEL, n_model)
    with _jax_sharded():
        model = (JLogisticRegression().set_max_iter(LR["iters"]).set_global_batch_size(LR["batch"])
                 .set_learning_rate(0.1).set_tol(0.0).fit(JDataFrame.from_dict({"features": X, "label": y})))
    np.testing.assert_allclose(_fit(worlds[world], "lr")["coef"], np.asarray(model.coefficient),
                               rtol=0, atol=SGD_ATOL)


def test_two_tp_fits_in_one_world_make_no_new_groups(worlds):
    got = _fit(worlds[4], "groups")
    assert got["asked"].tolist()[0] > 0 and got["asked"].tolist() == [got["asked"][0]] * 2  # both fits on 2 x 2
    assert got["made"].tolist() == [0, 0]  # the world's first fit ("lr") made them
    np.testing.assert_array_equal(got["coef1"], got["coef0"])
    np.testing.assert_array_equal(got["coef0"], _fit(worlds[4], "lr")["coef"])


def test_kmeans_and_the_mlp_on_a_tp_train_mesh_match_jax(worlds):
    from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
    from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifier as JMLPClassifier

    jconfig.set(JOptions.TRAIN_MESH, 2)
    jconfig.set(JOptions.TRAIN_MESH_MODEL, 2)
    with _jax_sharded():
        jk = (JKMeans().set_k(KMEANS["k"]).set_seed(KMEANS["seed"]).set_max_iter(KMEANS["iters"])
              .set_distance_measure(KMEANS["measure"]).fit(JDataFrame.from_dict({"features": _blobs()})))
        X, y = _dense()
        jm = (JMLPClassifier().set_hidden_layers(MLP["hidden"]).set_max_iter(MLP["iters"])
              .set_global_batch_size(MLP["batch"]).set_seed(MLP["seed"]).set_tol(0.0)
              .fit(JDataFrame.from_dict({"features": X, "label": y})))
    got = _fit(worlds[4], "kmeans")
    order = np.argsort(got["centroids"][:, 0])
    jorder = np.argsort(np.asarray(jk.centroids)[:, 0])
    np.testing.assert_allclose(got["centroids"][order], np.asarray(jk.centroids)[jorder], rtol=0,
                               atol=CENTROID_ATOL)
    np.testing.assert_array_equal(got["weights"][order], np.asarray(jk.weights)[jorder])
    assert int(got["fits"]) == 0  # the deterministic tier is data-parallel only
    mlp = _fit(worlds[4], "mlp")
    for i, (W, b) in enumerate(jm.params):
        np.testing.assert_allclose(mlp[f"W{i}"], np.asarray(W), rtol=0, atol=MLP_ATOL)
        np.testing.assert_allclose(mlp[f"b{i}"], np.asarray(b), rtol=0, atol=MLP_ATOL)


def test_a_killed_tp_fit_resumes_bit_equal_to_its_clean_fit(worlds):
    got = _fit(worlds[8], "ckpt")
    np.testing.assert_array_equal(got["resumed"], got["clean"])
    assert list(got["steps"]) == [5, 10]


def test_tp_snapshots_cross_between_the_packages(worlds, tp_dir, tmp_path):
    killed = os.path.join(tp_dir, "ckpt", "killed")
    # the port's 4 x 2 snapshot: one piece a model shard of the padded coefficient
    step, state = ShardedCheckpointManager(killed, sharding=(4, 2)).restore_latest()
    jstep, jstate = JShardedCheckpointManager(killed, sharding=(4, 2)).restore_latest()
    assert step == jstep and step >= 10  # the resumed fit's last snapshot
    coef = np.asarray(state[0])
    assert coef.shape == (D_DENSE + 1,) and coef[-1] == 0.0
    np.testing.assert_array_equal(np.asarray(jstate[0]), coef)
    assert int(jstate[1]) == int(state[1])
    # restored whole on another mesh shape; a manager held to one refuses it
    np.testing.assert_array_equal(np.asarray(ShardedCheckpointManager(killed).restore_latest()[1][0]), coef)
    with pytest.raises(MeshMismatchError):
        ShardedCheckpointManager(killed, sharding=(2, 2)).restore_latest()
    # JAX's 4 x 2 host loop, read by the port
    X, _ = _dense()
    ctx = JMeshContext(devices=jax.devices()[:8], n_data=4, n_model=2)
    jmgr = JShardedCheckpointManager(str(tmp_path / "jax"), sharding=(4, 2))
    with _jax_sharded():
        jcoef = JSGD(ctx=ctx, checkpoint_manager=jmgr, checkpoint_interval=5, **CKPT_SGD).optimize(
            np.zeros(D_DENSE, np.float32), {"features": X, "labels": X @ np.ones(D_DENSE, np.float32)},
            JLeastSquareLoss.INSTANCE)
    step, state = ShardedCheckpointManager(str(tmp_path / "jax"), sharding=(4, 2)).restore_latest()
    jstep, jstate = jmgr.restore_latest()
    assert step == jstep
    np.testing.assert_array_equal(np.asarray(state[0]), np.asarray(jstate[0]))
    np.testing.assert_allclose(_fit(worlds[8], "ckpt")["clean"], jcoef, rtol=0, atol=SGD_ATOL)


def test_tp_resolution_and_the_rank_grid():
    from flink_ml_tpu_torch.parallel.mesh import MeshContext
    from flink_ml_tpu_torch.parallel.train_sharding import TrainSharding, resolve_train_sharding

    config.set(Options.TRAIN_MESH, 1)
    config.set(Options.TRAIN_MESH_MODEL, 2)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        resolve_train_sharding("cpu")
    ts = TrainSharding(4, 2)
    assert ts.key == (4, 2) and ts.row_quantum == 32  # the deal runs over the data shards
    ctx = MeshContext.__new__(MeshContext)
    ctx.__dict__.update(n_data=4, n_model=2, n_slices=2, rank=5)
    assert (ctx.data_index, ctx.model_index, ctx.slice_index) == (2, 1, 1)
    assert ctx.data_axes == ("slice", "data")
    assert ctx.model_range(5) == (3, 6, 6)
