"""OnlineKMeans on ``train.mesh``'s data axis against itself and the JAX
package: gloo worlds of 1, 2 and 4 ranks on the CPU, each spawned once for
the module through ``tests/torch_sharded_worker.py``'s ``online_kmeans``.

Each batch is dealt over the ranks (``TrainSharding.deal_cache``) and
reduced by the deterministic tier (``kmeans.py`` ``_sharded_epoch_tot``)
before the decay and blend, so every version's centroids and weights are
bit-identical on every rank and at every width. Against the JAX package's
sharded online fit (JAX ``online_kmeans.py:171-199``, on the conftest's
host devices) and against the port's one-device step: rtol 1e-5 / atol
1e-6, float32 sums in another order. A model axis of 2 (``train.mesh`` 2 ×
``train.mesh.model`` 2, in the world of 4) drops to the one-device step on
every rank, as in the JAX package: bit-equal to the one-device fit here.
"""
import numpy as np
import pytest
import torch

from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.models.clustering.online_kmeans import OnlineKMeans as JOnlineKMeans
from flink_ml_tpu.models.online import QueueBatchStream as JQueueBatchStream

from flink_ml_tpu_torch.config import Options, config

from tests.test_torch_sharded_training import _jax_train_mesh
from tests.torch_sharded_worker import online_kmeans, run_world

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
WIDTHS = (1, 2, 4)
KW = dict(k=4, seed=3, decay=0.5)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for opt in (Options.TRAIN_MESH, Options.TRAIN_MESH_MODEL):
        config.unset(opt)
    for opt in (JOptions.TRAIN_MESH, JOptions.TRAIN_MESH_MODEL):
        jconfig.unset(opt)


def _batches():
    """Six seeded batches of 4 blobs in d 8: ragged row counts, so the deal
    pads some with masked rows at width 2 and 4."""
    rng = np.random.default_rng(17)
    centers = rng.normal(0.0, 3.0, size=(4, 8))
    return [{"features": (centers[rng.integers(0, 4, rows)] + rng.normal(0.0, 0.6, size=(rows, 8)))}
            for rows in (64, 37, 128, 8, 93, 200)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{width: {scenario: [each rank's arrays]}}, each world spawned once."""
    tmp = str(tmp_path_factory.mktemp("online"))
    out = {}
    for w in WIDTHS:
        scenarios = [("online", "online_kmeans", dict(batches=_batches(), **KW))]
        if w == 4:
            scenarios.append(("online_2x2", "online_kmeans", dict(batches=_batches(), mesh=(2, 2), **KW)))
        out[w] = run_world(w, scenarios, tmp, tag="online")
    return out


def _jax(width):
    with _jax_train_mesh(width):
        stream = JQueueBatchStream()
        model = (JOnlineKMeans().set_k(KW["k"]).set_seed(KW["seed"]).set_decay_factor(KW["decay"])
                 .set_random_initial_model_data(dim=8).fit(stream))
        cs, ws = [], []
        for batch in _batches():
            stream.add(batch)
            assert model.advance(1) == 1
            cs.append(model.centroids)
            ws.append(model.weights)
    return np.stack(cs), np.stack(ws)


@pytest.mark.parametrize("width", WIDTHS)
def test_every_rank_holds_the_same_versions_on_the_deterministic_tier(worlds, width):
    ranks = worlds[width]["online"]
    assert len(ranks) == width
    for got in ranks:
        assert int(got["fits"]) == 1
        np.testing.assert_array_equal(got["versions"], np.arange(1, 7))
        for name in ("centroids", "weights"):
            np.testing.assert_array_equal(got[name], ranks[0][name], err_msg=name)


@pytest.mark.parametrize("width", [2, 4])
def test_every_version_is_bit_equal_to_width_one(worlds, width):
    for name in ("centroids", "weights"):
        np.testing.assert_array_equal(worlds[width]["online"][0][name], worlds[1]["online"][0][name],
                                      err_msg=f"{name} at width {width}")


@pytest.mark.parametrize("jax_width", [1, 2])
def test_width_one_matches_the_jax_sharded_fit(worlds, jax_width):
    jc, jw = _jax(jax_width)
    got = worlds[1]["online"][0]
    np.testing.assert_allclose(got["centroids"], jc, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["weights"], jw, rtol=RTOL, atol=ATOL)


def test_the_deterministic_tier_lands_near_the_one_device_step(worlds):
    one = online_kmeans(_batches(), device="cpu", **KW)
    assert int(one["fits"]) == 0
    for name in ("centroids", "weights"):
        np.testing.assert_allclose(worlds[1]["online"][0][name], one[name], rtol=RTOL, atol=ATOL, err_msg=name)


def test_a_model_axis_drops_to_the_one_device_step(worlds):
    one = online_kmeans(_batches(), device="cpu", **KW)
    for got in worlds[4]["online_2x2"]:
        assert int(got["fits"]) == 0
        for name in ("centroids", "weights"):
            np.testing.assert_array_equal(got[name], one[name], err_msg=name)
