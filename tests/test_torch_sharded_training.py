"""The port's sharded training (``train.mesh``) in gloo worlds of 1, 2, 4 and
8 ranks on the CPU, against itself across widths and against the JAX
package's ``TrainSharding`` programs.

Each world is spawned once for the module (``tests/torch_sharded_worker.py``)
and runs every scenario of that width: every rank is handed the same whole
input and calls the same entry point, as a user's ranks would, and writes
its results to ``tmp_path``. The JAX side runs here on the conftest's 8
host devices, under ``_jax_sharded``: ``jax.shard_map`` with its
replication check off (on jax 0.9 the JAX package's sharded programs
otherwise fail shard_map's checks, as ``tests/test_sharded_training.py``
shows), and every JAX program cache those calls use emptied first and
restored afterwards, so no program built elsewhere is reused and a later
test file in this worker finds the caches as they were.

Tolerances, each with its reason:
- dense SGD, KMeans and LogisticRegression across the port's widths: bit
  for bit (the deterministic tier, by construction);
- every rank's model: bit-equal to rank 0's;
- dense and sparse SGD against JAX at the same width: coefficients within
  1e-6 absolute (``test_torch_linear_family.py``'s bound: float32 sums in
  another order; the margins here are pairwise folds, JAX's a gemv);
- KMeans against JAX: centroids within 1e-5 and weights equal on blobs whose
  every row is decided past a 1e-4 float64 top-two gap
  (``test_torch_kmeans.py``'s bounds);
- the MLP at width 2 against JAX at ``train.mesh`` 2: parameters within
  1e-5 absolute and probabilities within 1e-5 (``test_torch_mlp.py``'s
  bound on the fitted model's probabilities).
"""
import contextlib
import os

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.checkpoint import ShardedCheckpointManager as JShardedCheckpointManager
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.linalg.vectors import SparseVector as JSparseVector
from flink_ml_tpu.models.classification.logistic_regression import LogisticRegression as JLogisticRegression
from flink_ml_tpu.models.classification.mlp_classifier import MLPClassifier as JMLPClassifier
from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
from flink_ml_tpu.ops import SGD as JSGD
from flink_ml_tpu.ops.lossfunc import BinaryLogisticLoss as JBinaryLogisticLoss
from flink_ml_tpu.parallel import TrainSharding as JTrainSharding

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.checkpoint import ShardedCheckpointManager
from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifierModel

from tests.torch_sharded_worker import rank_rows, run_world

torch.set_num_threads(1)

WIDTHS = (1, 2, 4, 8)
SPARSE_WIDTHS = (2, 4)
SGD_ATOL = 1e-6
CENTROID_ATOL = 1e-5
MLP_ATOL = 1e-5
MARGIN = 1e-4

DENSE_SGD = dict(max_iter=23, learning_rate=0.1, global_batch_size=64, tol=0.0, reg=0.01, elastic_net=0.3)
SPARSE_DIM = 1 << 14
SPARSE_SGD = dict(max_iter=6, learning_rate=0.5, global_batch_size=200, tol=0.0, reg=0.01)
KMEANS = dict(k=3, seed=5, iters=9, measure="euclidean")
LR = dict(iters=12, batch=64)
MLP = dict(hidden=8, iters=6, batch=64, seed=1)
CKPT_SGD = dict(max_iter=20, learning_rate=0.05, global_batch_size=32, tol=0.0)
CKPT_FAIL_AT = 12


def _dense():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = (X @ np.linspace(1.0, -1.0, 5) > 0).astype(np.float32)
    return X, y


def _blobs():
    rng = np.random.default_rng(7)
    return np.concatenate([rng.normal(c, 0.5, (47, 3)) for c in (-3.0, 0.0, 3.0)]).astype(np.float32)


def _sparse():
    """Padded-CSR rows: 500 rows of up to 8 features of 2^14 (value 0 is
    padding), labels from a seeded teacher."""
    rng = np.random.default_rng(11)
    n, K = 500, 8
    idx = np.sort(rng.integers(0, SPARSE_DIM, size=(n, K)), axis=1).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.25] = 0.0
    teacher = rng.normal(size=SPARSE_DIM)
    y = ((val * teacher[idx]).sum(axis=1) > 0).astype(np.float32)
    return {"indices": idx, "values": val, "labels": y}


def _scenarios(width, tmp):
    X, y = _dense()
    out = [
        ("dense_sgd", "sgd", dict(data={"features": X, "labels": y}, dim=5, **DENSE_SGD)),
        ("kmeans", "kmeans", dict(points=_blobs(), **KMEANS)),
        ("lr", "logistic_regression", dict(features=X, labels=y, **LR)),
        ("collectives", "collectives", {}),
    ]
    if width in SPARSE_WIDTHS:
        for kernel in ("scatter", "onehot"):
            out.append((f"sparse_{kernel}", "sgd",
                        dict(data=_sparse(), dim=SPARSE_DIM, sparse_kernel=kernel, **SPARSE_SGD)))
    if width == 2:
        out.append(("mlp", "mlp", dict(features=X, labels=y, **MLP)))
        out.append(("ckpt", "sgd_killed_and_resumed",
                    dict(data={"features": X, "labels": X @ np.ones(5, np.float32)}, dim=5,
                         ckpt_dir=os.path.join(tmp, "ckpt"), fail_at=CKPT_FAIL_AT, **CKPT_SGD)))
    if width == 4:  # the width-2 fit's snapshot, restored four wide
        out.append(("restored", "restore_snapshot", dict(ckpt_dir=os.path.join(tmp, "ckpt", "killed"))))
    return out


@pytest.fixture(scope="module")
def sharded_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded"))


@pytest.fixture(scope="module")
def worlds(sharded_dir):
    """{width: {scenario: [rank 0's arrays, rank 1's, ...]}}, each world
    spawned once; the width-4 world runs after the width-2 one, whose
    snapshot it restores."""
    return {w: run_world(w, _scenarios(w, sharded_dir), sharded_dir) for w in WIDTHS}


@contextlib.contextmanager
def _jax_sharded(check_vma: bool = False):
    """The JAX package's sharded programs with shard_map's replication check
    off (``check_vma`` False), built afresh: every program cache they use is
    emptied first, so no program built elsewhere is reused, and restored
    afterwards, so none built here stays."""
    import flink_ml_tpu.models.classification.mlp_classifier as jmlp
    import flink_ml_tpu.models.clustering.kmeans as jkmeans
    import flink_ml_tpu.ops.optimizer as jopt
    import flink_ml_tpu.parallel.collectives as jcollectives

    caches = (jopt._FUSED_CACHE, jkmeans._SHARDED_PROGRAMS, jmlp._MLP_FUSED_CACHE)
    lru_caches = (jopt._premat_materialize_jit, jcollectives._shard_mapped_sum)
    saved = [dict(c) for c in caches]
    real = jax.shard_map

    def shard_map(f, *args, **kwargs):
        kwargs["check_vma"] = check_vma
        return real(f, *args, **kwargs)

    for cache in caches:
        cache.clear()
    for cache in lru_caches:
        cache.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "shard_map", shard_map)
        try:
            yield
        finally:
            for cache, before in zip(caches, saved):
                cache.clear()
                cache.update(before)
            for cache in lru_caches:
                cache.cache_clear()


@contextlib.contextmanager
def _jax_train_mesh(width):
    jconfig.set(JOptions.TRAIN_MESH, width)
    try:
        with _jax_sharded():
            yield
    finally:
        jconfig.unset(JOptions.TRAIN_MESH)


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_every_rank_returns_the_same_model(worlds, width):
    for name, ranks in worlds[width].items():
        assert len(ranks) == width, name
        for r in ranks[1:]:
            _same(ranks[0], r)


@pytest.mark.parametrize("name, keys", [("dense_sgd", ("coef", "losses")),
                                        ("kmeans", ("centroids", "weights")), ("lr", ("coef",))])
@pytest.mark.parametrize("width", WIDTHS[1:])
def test_the_deterministic_tier_is_bit_equal_across_widths(worlds, name, keys, width):
    for k in keys:
        np.testing.assert_array_equal(worlds[width][name][0][k], worlds[1][name][0][k], err_msg=k)


@pytest.mark.parametrize("width", WIDTHS)
def test_the_psum_collectives_sum_every_ranks_rows(worlds, width):
    rows = np.concatenate([rank_rows(r) for r in range(width)]).astype(np.float64)
    tri = width * (width + 1) / 2  # the ranks' values 1..width, summed
    for got in worlds[width]["collectives"]:
        np.testing.assert_allclose(got["sum"], rows.sum(axis=0), rtol=1e-6)
        np.testing.assert_allclose(got["mean"], rows.mean(axis=0), rtol=1e-6)
        assert float(got["a0"]) == tri and float(got["a1"]) == 2 * tri
        np.testing.assert_array_equal(got["b"], np.full(3, tri, np.float32))
        assert got["placed_on"].tolist() == ["cpu", "cpu"]
        np.testing.assert_array_equal(got["placed"], np.arange(3.0))


def test_kmeans_counts_its_sharded_fits_and_every_point(worlds):
    n = len(_blobs())
    for w in WIDTHS:
        got = worlds[w]["kmeans"][0]
        assert int(got["fits"]) == 1
        assert got["weights"].sum() == n
        # the deal pads to a multiple of the quantum 8·N (one quantum's batch)
        assert int(got["ingest_rows"]) == n
        assert int(got["pad_rows"]) == -n % (8 * w)


# ---------------------------------------------------------------------------
# against the JAX package's TrainSharding programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_dense_sgd_matches_jax_train_sharding(worlds, width):
    X, y = _dense()
    with _jax_sharded():
        opt = JSGD(sharding=JTrainSharding(width), **DENSE_SGD)
        ref = np.asarray(opt.optimize(np.zeros(5), {"features": X, "labels": y}, JBinaryLogisticLoss.INSTANCE))
    got = worlds[width]["dense_sgd"][0]
    np.testing.assert_allclose(got["coef"], ref, rtol=0, atol=SGD_ATOL)
    np.testing.assert_allclose(got["losses"], opt.loss_history, rtol=1e-5)


@pytest.mark.parametrize("width", WIDTHS)
def test_logistic_regression_matches_jax_on_train_mesh(worlds, width):
    X, y = _dense()
    with _jax_train_mesh(width):
        model = (JLogisticRegression().set_max_iter(LR["iters"]).set_global_batch_size(LR["batch"])
                 .set_learning_rate(0.1).set_tol(0.0)
                 .fit(JDataFrame.from_dict({"features": list(X), "label": y.astype(np.float64)})))
    np.testing.assert_allclose(worlds[width]["lr"][0]["coef"], model.coefficient, rtol=0, atol=SGD_ATOL)


def _pairwise64(X, C):
    return np.sqrt(((X[:, None, :].astype(np.float64) - C[None, :, :]) ** 2).sum(-1))


@pytest.mark.parametrize("width", WIDTHS)
def test_kmeans_matches_jax_train_mesh(worlds, width):
    pts = _blobs()
    with _jax_train_mesh(width):
        jmodel = (JKMeans().set_k(KMEANS["k"]).set_seed(KMEANS["seed"]).set_max_iter(KMEANS["iters"])
                  .set_distance_measure(KMEANS["measure"]).fit(JDataFrame.from_dict({"features": list(pts)})))
    got = worlds[width]["kmeans"][0]
    top = np.sort(_pairwise64(pts, np.asarray(jmodel.centroids)), axis=1)
    assert (top[:, 1] - top[:, 0] > MARGIN).all()  # every row decided: assignments must agree
    np.testing.assert_allclose(got["centroids"], jmodel.centroids, rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(got["weights"], jmodel.weights)


@pytest.mark.parametrize("kernel", ["scatter", "onehot"])
@pytest.mark.parametrize("width", SPARSE_WIDTHS)
def test_sparse_sgd_matches_jax_at_the_same_width(worlds, kernel, width):
    """The psum paths: each rank takes ceil(B / N) rows of its contiguous
    share, so the global minibatch changes with the width — the JAX package
    runs the same schedule only at the same width."""
    data = _sparse()
    with _jax_sharded():
        opt = JSGD(sparse_kernel=kernel, sharding=JTrainSharding(width), **SPARSE_SGD)
        ref = np.asarray(opt.optimize(np.zeros(SPARSE_DIM), data, JBinaryLogisticLoss.INSTANCE))
    got = worlds[width][f"sparse_{kernel}"][0]
    np.testing.assert_allclose(got["coef"], ref, rtol=0, atol=SGD_ATOL)
    np.testing.assert_allclose(got["losses"], opt.loss_history, rtol=1e-5)
    if width == 2:  # the width changes the schedule, and with it the fit
        assert not np.array_equal(got["coef"], worlds[4][f"sparse_{kernel}"][0]["coef"])


def test_sparse_scatter_and_onehot_agree_on_the_mesh(worlds):
    for w in SPARSE_WIDTHS:
        np.testing.assert_allclose(worlds[w]["sparse_onehot"][0]["coef"],
                                   worlds[w]["sparse_scatter"][0]["coef"], rtol=0, atol=SGD_ATOL)


def test_mlp_matches_jax_on_train_mesh_2(worlds):
    X, y = _dense()
    with _jax_train_mesh(2):
        jmodel = (JMLPClassifier().set_hidden_layers(MLP["hidden"]).set_max_iter(MLP["iters"])
                  .set_global_batch_size(MLP["batch"]).set_seed(MLP["seed"]).set_tol(0.0)
                  .fit(JDataFrame.from_dict({"features": list(X), "label": y.astype(np.float64)})))
    got = worlds[2]["mlp"][0]
    params = []
    for i, (W, b) in enumerate(jmodel.params):
        np.testing.assert_allclose(got[f"W{i}"], np.asarray(W), rtol=0, atol=MLP_ATOL)
        np.testing.assert_allclose(got[f"b{i}"], np.asarray(b), rtol=0, atol=MLP_ATOL)
        params.append((got[f"W{i}"], got[f"b{i}"]))
    model = MLPClassifierModel()
    model.params, model.labels = params, np.asarray(jmodel.labels)
    probs = np.asarray(model.transform(DataFrame.from_dict({"features": X}), device="cpu").column("rawPrediction"))
    ref = np.asarray(jmodel.transform(JDataFrame.from_dict({"features": list(X)})).column("rawPrediction"))
    np.testing.assert_allclose(probs, ref, rtol=0, atol=MLP_ATOL)
    assert len(got["losses"]) == MLP["iters"] and np.isfinite(got["losses"]).all()


# ---------------------------------------------------------------------------
# the host loop and ShardedCheckpointManager on the mesh
# ---------------------------------------------------------------------------


def test_a_killed_mesh_fit_resumes_bit_equal_to_its_clean_fit(worlds):
    got = worlds[2]["ckpt"][0]
    np.testing.assert_array_equal(got["resumed"], got["clean"])
    assert got["steps"].tolist() == [5, 10]  # max_to_keep 2, killed at epoch 12
    np.testing.assert_array_equal(got["resumed_losses"], got["clean_losses"][10:])


def test_the_width_2_snapshot_restores_at_width_4_and_in_both_packages(worlds, sharded_dir):
    restored = worlds[4]["restored"]
    ckpt = os.path.join(sharded_dir, "ckpt", "killed")
    step, state = ShardedCheckpointManager(ckpt, sharding=(4, 1)).restore_latest()
    jstep, jstate = JShardedCheckpointManager(ckpt, sharding=(4, 1)).restore_latest()
    # the resumed fit's last snapshot: epoch 15 (the run ends at 20 unsaved)
    assert int(restored[0]["step"]) == step == jstep == 15
    for r in restored:
        np.testing.assert_array_equal(r["coef"], state[0].numpy())
    np.testing.assert_array_equal(np.asarray(jstate[0]), state[0].numpy())
    assert int(np.asarray(jstate[1])) == int(state[1]) == int(restored[0]["offset"])


def test_a_torchrun_launch_joins_the_world_from_its_environment(tmp_path):
    """The user's launch: two ranks under torchrun on the CPU, each setting
    only train.mesh; the port's ensure_distributed makes the gloo group from
    torchrun's environment, and both ranks fit the width-2 program."""
    import subprocess
    import sys

    from tests.torch_sharded_worker import torchrun_rows

    worker = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(os.path.dirname(worker)),
                                                       os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                           worker, str(tmp_path)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    coefs = [np.load(tmp_path / f"torchrun_r{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(coefs[0], coefs[1])
    X, y = torchrun_rows()
    with _jax_train_mesh(2):
        model = (JLogisticRegression().set_max_iter(15).set_global_batch_size(128).set_learning_rate(0.1)
                 .set_tol(0.0).fit(JDataFrame.from_dict({"features": list(X), "label": y.astype(np.float64)})))
    np.testing.assert_allclose(coefs[0], model.coefficient, rtol=0, atol=SGD_ATOL)


def test_a_jax_sharded_fit_needs_the_check_off_and_leaves_the_caches_as_they_were():
    """The fixture's premise: without it the JAX package's deterministic
    program fails shard_map's type checks on this jax (the scan carry's
    varying axes), and with it the fit runs and no program stays cached."""
    import flink_ml_tpu.ops.optimizer as jopt

    X, y = _dense()
    before = dict(jopt._FUSED_CACHE)
    fit = lambda: JSGD(sharding=JTrainSharding(2), **DENSE_SGD).optimize(  # noqa: E731
        np.zeros(5), {"features": X, "labels": y}, JBinaryLogisticLoss.INSTANCE)
    with _jax_sharded(check_vma=True), pytest.raises((TypeError, ValueError)):
        fit()
    with _jax_sharded():
        assert np.isfinite(fit()).all()
    assert jopt._FUSED_CACHE.keys() == before.keys()
