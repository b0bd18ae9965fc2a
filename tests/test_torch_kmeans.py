"""The port's KMeans slice against the JAX package on the CPU:
``ops/distance`` (pairwise, distance, find_closest for the three measures),
``KMeans.fit`` on a one-device mesh, ``KMeansModel`` (transform, model data,
save/load both ways, ``load_servable``, the ``CLASS_TABLE`` rows), the
servable, the serving plan in both fusion tiers for ``("kmeans",)`` and
``("scale", "kmeans")`` (the JAX megakernel in Pallas interpret mode, as
``tests/test_fusion.py`` runs it), the cost model's choice per bucket, the
server, and the ``scale_kmeans`` wrapper's device rule. Tests of the CUDA
kernel itself are in ``test_torch_gpu.py``.

Tolerances, each with its reason:
- distances: atol 1e-5 — the dot products and norms sum in another order
  in the two frameworks (measured: at most 7.2e-7 at these sizes);
- assignments: equal wherever the float64 top-two distance gap exceeds
  ``MARGIN`` = 1e-4 (the MLP slice's margin): below it, two summation
  orders may round the two nearest distances either way. Each check counts
  the rows that fall inside. A row with a NaN distance is always decided:
  both packages must take the first NaN;
- the fit: centroids within atol 1e-5 of the JAX fit (float32 means of a
  few hundred points, whose sums differ in their last bits at most) and
  weights equal. Uniform data, whose rows sit near ties, is held epoch by
  epoch from the JAX package's centroids of that epoch, as well as blobs
  whose every row is decided;
- the scaled column: bit-equal (two correctly rounded float32 operations).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flink_ml_tpu.servable.lib as jlib
from flink_ml_tpu.api.dataframe import DataFrame as JDataFrame
from flink_ml_tpu.builder.pipeline import PipelineModel as JPipelineModel
from flink_ml_tpu.config import Options as JOptions, config as jconfig
from flink_ml_tpu.models.clustering.kmeans import (
    KMeans as JKMeans,
    KMeansModel as JKMeansModel,
    _epoch_update as j_epoch_update,
)
from flink_ml_tpu.models.feature.standard_scaler import StandardScaler as JStandardScaler
from flink_ml_tpu.ops.distance import DistanceMeasure as JDistanceMeasure
from flink_ml_tpu.parallel.mesh import MeshContext, mesh_context
from flink_ml_tpu.servable.builder import PipelineModelServable as JPipeline
from flink_ml_tpu.servable.fusion import FusionTier as JFusionTier
from flink_ml_tpu.serving.plan import CompiledServingPlan as JPlan
from flink_ml_tpu.serving.server import InferenceServer as JServer, ServingConfig as JServingConfig

import flink_ml_tpu_torch.ops.kernels as tk
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.metrics import MLMetrics, metrics
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans, KMeansModel, _epoch_update
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler
from flink_ml_tpu_torch.ops.distance import DistanceMeasure
from flink_ml_tpu_torch.servable import (
    KMeansModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
    load_servable,
    servable_from_arrays,
)
from flink_ml_tpu_torch.servable.fusion import FusionTier, chain_score
from flink_ml_tpu_torch.servable.megakernels import (
    KMEANS_MAX_DIM,
    KMEANS_MAX_K,
    SCALE_KMEANS,
    chain_eligible,
    scale_kmeans,
    scale_kmeans_plain,
)
from flink_ml_tpu_torch.serving import InferenceServer, ServingConfig
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan, chain_kinds
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

MEASURES = ("euclidean", "manhattan", "cosine")
MARGIN = 1e-4
DIST_ATOL = 1e-5
CENTROID_ATOL = 1e-5
N, D, K, ITERS = 600, 8, 4, 5
FLAGS = [(True, True), (False, True)]


@pytest.fixture(autouse=True)
def _reset_config():
    """Every option a test here sets is unset after it: the test workers run
    other files in the same process."""
    yield
    config.unset(Options.TRAIN_MESH)
    config.unset(Options.TRAIN_MESH_MODEL)
    config.unset(Options.FUSION_MEGAKERNEL_MIN_SCORE)
    jconfig.unset(JOptions.FUSION_MEGAKERNEL_MIN_SCORE)


@pytest.fixture
def one_device_mesh():
    with mesh_context(MeshContext(n_data=1, n_model=1)) as ctx:
        yield ctx


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _uniform(n, d, seed):
    """Rows of the published generator's kind: uniform [0, 1)^d."""
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _blobs(n, d, k, seed, fit_seed=11):
    """Rows around k well-separated centres (spread 0.05, centres ~10
    apart), laid out so the rows a fit with ``fit_seed`` draws as its
    initial centroids lie one in each blob: the clustering is well posed,
    and every row is decided at every epoch."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 10.0
    labels = rng.integers(0, k, size=n)
    labels[np.random.default_rng(fit_seed).choice(n, size=k, replace=False)] = np.arange(k)
    return (centres[labels] + rng.normal(size=(n, d)) * 0.05).astype(np.float32)


def _pairwise64(measure, X, C):
    """The measure's distances in float64 (the direct forms)."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        if measure == "euclidean":
            return np.sqrt(np.sum((X[:, None, :] - C[None, :, :]) ** 2, axis=-1))
        if measure == "manhattan":
            return np.sum(np.abs(X[:, None, :] - C[None, :, :]), axis=-1)
        return 1.0 - (X @ C.T) / np.linalg.norm(X, axis=1)[:, None] / np.linalg.norm(C, axis=1)[None, :]


def _decided(measure, X, C):
    """Rows whose float64 top-two distance gap exceeds MARGIN; rows with a
    NaN distance are decided (the first NaN wins in both packages)."""
    dist = _pairwise64(measure, X, C)
    top = np.sort(dist, axis=1)
    return np.isnan(dist).any(axis=1) | (top[:, 1] - top[:, 0] > MARGIN)


def _assert_assignments(port, ref, decided, where=""):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(port[decided], ref[decided], err_msg=where)
    return int((~decided).sum())


# ---------------------------------------------------------------------------
# ops/distance
# ---------------------------------------------------------------------------


def test_get_instance_and_its_error_match_jax():
    for name in MEASURES:
        assert type(DistanceMeasure.get_instance(name)).__name__ == type(JDistanceMeasure.get_instance(name)).__name__
    for dm in (DistanceMeasure, JDistanceMeasure):
        with pytest.raises(ValueError) as e:
            dm.get_instance("chebyshev")
        assert str(e.value) == ("distanceMeasure chebyshev is not recognized. Supported options: "
                                "'euclidean, manhattan, cosine'.")
    assert tk.kmeans_assign_fn("cosine") is not None
    with pytest.raises(ValueError, match="not recognized"):
        tk.kmeans_assign_fn("chebyshev")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n,d,k", [(N, D, K), (203, 100, 10)])
def test_pairwise_distance_and_find_closest_match_jax(measure, n, d, k):
    X, C = _uniform(n, d, seed=d), _uniform(k, d, seed=d + 1)
    port, ref = DistanceMeasure.get_instance(measure), JDistanceMeasure.get_instance(measure)
    dist = port.pairwise(_t(X), _t(C))
    assert dist.shape == (n, k) and dist.dtype == torch.float32
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref.pairwise(jnp.asarray(X), jnp.asarray(C))),
                               rtol=0, atol=DIST_ATOL)
    np.testing.assert_allclose(dist.numpy(), _pairwise64(measure, X, C), rtol=0, atol=DIST_ATOL)
    one = port.distance(_t(X[3]), _t(C[1]))
    assert one.dim() == 0
    np.testing.assert_allclose(float(one), float(ref.distance(X[3], C[1])), rtol=0, atol=DIST_ATOL)
    idx = port.find_closest(_t(X), _t(C))
    assert idx.dtype == torch.int64
    inside = _assert_assignments(idx.numpy(), ref.find_closest(jnp.asarray(X), jnp.asarray(C)),
                                 _decided(measure, X, C), f"{measure} {n}x{d} k={k}")
    assert inside < n // 20, f"{inside} rows inside the tie margin"


def test_manhattan_chunks_rows_without_changing_them(monkeypatch):
    import flink_ml_tpu_torch.ops.distance as dist_mod

    X, C = _uniform(97, 8, seed=1), _uniform(5, 8, seed=2)
    whole = DistanceMeasure.get_instance("manhattan").pairwise(_t(X), _t(C))
    monkeypatch.setattr(dist_mod, "_MANHATTAN_CHUNK_ELEMENTS", 7 * 5 * 8)  # 7-row chunks
    chunked = DistanceMeasure.get_instance("manhattan").pairwise(_t(X), _t(C))
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("measure", MEASURES)
def test_find_closest_edge_cases_match_jax(measure):
    """Duplicate centroids take the first index; a zero row under cosine
    (0/0) and a NaN feature under every measure give NaN in every column,
    index 0; a zero centroid under cosine is a NaN column, which wins."""
    C = _uniform(4, 6, seed=3)
    C[2] = C[0]  # a duplicate of centroid 0
    X = np.stack([C[0], C[0] * 0.999 + 0.0005, C[2], np.zeros(6), C[3], C[1]]).astype(np.float32)
    X[4, 2] = np.nan
    port = DistanceMeasure.get_instance(measure).find_closest(_t(X), _t(C)).tolist()
    ref = np.asarray(JDistanceMeasure.get_instance(measure).find_closest(jnp.asarray(X), jnp.asarray(C))).tolist()
    assert port == ref
    assert port[0] == port[2] == 0 and port[4] == 0 and port[5] == 1
    if measure == "cosine":
        assert port[3] == 0  # the zero row: NaN everywhere
        Cz = C.copy()
        Cz[3] = 0.0  # a zero centroid: its column is NaN
        got = DistanceMeasure.get_instance("cosine").find_closest(_t(X), _t(Cz)).tolist()
        want = np.asarray(JDistanceMeasure.get_instance("cosine").find_closest(jnp.asarray(X), jnp.asarray(Cz)))
        assert got == want.tolist() == [3, 3, 3, 0, 0, 3]
    nan_first = torch.tensor([[3.0, float("nan"), 1.0, float("nan")], [2.0, 1.0, 1.0, 5.0]])
    assert torch.argmin(nan_first, dim=1).tolist() == [1, 1]
    assert np.asarray(jnp.argmin(jnp.asarray(nan_first.numpy()), axis=1)).tolist() == [1, 1]


# ---------------------------------------------------------------------------
# KMeans.fit against the JAX fit on a one-device mesh
# ---------------------------------------------------------------------------


def _configure(est, measure, k=K, iters=ITERS, seed=11):
    return est.set_k(k).set_max_iter(iters).set_seed(seed).set_distance_measure(measure)


def _fit_pair(X, measure, **kw):
    model = _configure(KMeans(), measure, **kw).fit(DataFrame.from_dict({"features": X}), device="cpu")
    jmodel = _configure(JKMeans(), measure, **kw).fit(JDataFrame.from_dict({"features": X}))
    return model, jmodel


@pytest.mark.parametrize("measure", MEASURES)
def test_fit_starts_from_the_same_rows_as_jax(one_device_mesh, monkeypatch, measure):
    """Both fits hand their epoch loop the same initial centroids: the rows
    ``default_rng(seed).choice(n, k, replace=False)`` picks."""
    import flink_ml_tpu.models.clustering.kmeans as jkmeans
    import flink_ml_tpu_torch.models.clustering.kmeans as tkmeans

    seen = {}
    port_loop, jax_loop = tkmeans._train_loop, jkmeans._train_loop

    def port_spy(measure_name, k, n_epochs, centroids, X, mask):
        seen["port"] = centroids.numpy().copy()
        return port_loop(measure_name, k, n_epochs, centroids, X, mask)

    def jax_spy(measure_name, k, n_epochs):
        loop = jax_loop(measure_name, k, n_epochs)

        def spy(centroids, X, mask):
            seen["jax"] = np.asarray(centroids).copy()
            return loop(centroids, X, mask)

        return spy

    monkeypatch.setattr(tkmeans, "_train_loop", port_spy)
    monkeypatch.setattr(jkmeans, "_train_loop", jax_spy)
    X = _uniform(N, D, seed=4)
    model, jmodel = _fit_pair(X, measure, iters=1)
    pick = np.random.default_rng(11).choice(N, size=K, replace=False)
    np.testing.assert_array_equal(seen["port"], X[pick])
    np.testing.assert_array_equal(seen["jax"], X[pick])
    assert model.param_map_to_json() == jmodel.param_map_to_json()
    assert model.centroids.dtype == model.weights.dtype == np.float64
    assert model.centroids.shape == (K, D) and model.weights.sum() == N


@pytest.mark.parametrize("measure", MEASURES)
def test_fit_matches_the_jax_fit_on_blobs(one_device_mesh, measure):
    X = _blobs(N, D, K, seed=5)
    model, jmodel = _fit_pair(X, measure, iters=ITERS)
    np.testing.assert_allclose(model.centroids, jmodel.centroids, rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_array_equal(model.weights, jmodel.weights)
    assert model.weights.sum() == N
    # every row is decided at the fitted centroids: the blobs are far apart
    assert _decided(measure, X, jmodel.centroids).all()


@pytest.mark.parametrize("measure", MEASURES)
def test_fit_holds_each_epoch_against_jax_on_uniform_rows(one_device_mesh, measure):
    """Uniform rows sit near ties, and one flip would cascade through a fit;
    so each epoch starts from the JAX package's centroids of that epoch.
    Where no row is inside the margin the new centroids and counts agree
    with JAX's; where some are, with the float64 means over the port's
    assignment. The whole fits agree when no epoch had a row inside."""
    X = _uniform(N, D, seed=6)
    model, jmodel = _fit_pair(X, measure, iters=ITERS)
    c = jnp.asarray(X[np.random.default_rng(11).choice(N, size=K, replace=False)])
    jmeasure, pmeasure = JDistanceMeasure.get_instance(measure), DistanceMeasure.get_instance(measure)
    mask = np.ones(N, np.float32)
    inside_total = 0
    for epoch in range(ITERS):
        c_np = np.asarray(c)
        new, counts = _epoch_update(pmeasure, K, _t(c_np), _t(X), _t(mask))
        jnew, jcounts = j_epoch_update(jmeasure, K, c, jnp.asarray(X), jnp.asarray(mask))
        assign = pmeasure.find_closest(_t(X), _t(c_np)).numpy()
        inside = _assert_assignments(assign, jmeasure.find_closest(jnp.asarray(X), c),
                                     _decided(measure, X, c_np), f"{measure} epoch {epoch}")
        inside_total += inside
        if inside == 0:
            np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=0, atol=CENTROID_ATOL)
            np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        else:
            means = np.stack([X[assign == j].astype(np.float64).mean(axis=0) if (assign == j).any()
                              else c_np[j] for j in range(K)])
            np.testing.assert_allclose(new.numpy(), means, rtol=0, atol=CENTROID_ATOL)
        c = jnew
    assert inside_total < N // 20
    if inside_total == 0:
        np.testing.assert_allclose(model.centroids, jmodel.centroids, rtol=0, atol=CENTROID_ATOL)
        np.testing.assert_array_equal(model.weights, jmodel.weights)
    # the port's own fit is deterministic
    again = _configure(KMeans(), measure).fit(DataFrame.from_dict({"features": X}), device="cpu")
    np.testing.assert_array_equal(again.centroids, model.centroids)
    np.testing.assert_array_equal(again.weights, model.weights)


def test_fewer_rows_than_k_raise_as_in_jax(one_device_mesh):
    X = _uniform(3, D, seed=7)
    for est, df in ((KMeans(), DataFrame.from_dict({"features": X})),
                    (JKMeans(), JDataFrame.from_dict({"features": X}))):
        with pytest.raises(ValueError, match=r"KMeans needs at least k=4 points, got 3"):
            est.set_k(4).fit(df)


def test_a_centroid_without_points_keeps_its_position():
    X = _t(np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]]))
    c = _t(np.array([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]]))
    new, counts = _epoch_update(DistanceMeasure.get_instance("euclidean"), 3, c, X, torch.ones(3))
    assert counts.tolist() == [2.0, 1.0, 0.0]
    assert new[2].tolist() == [100.0, 100.0]
    np.testing.assert_allclose(new[0].numpy(), [0.05, 0.0], rtol=1e-6)


def test_unported_training_tiers_raise_naming_the_roadmap():
    X = _uniform(64, D, seed=8)
    # fit_stream is ported (queue A 7): with no cache it fails as the JAX
    # fit_stream does, reading the cache's row count
    with pytest.raises(AttributeError, match="num_rows"):
        KMeans().fit_stream(None, device="cpu")
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        with pytest.raises(AttributeError, match="num_rows"):
            JKMeans().fit_stream(None)
    config.set(Options.TRAIN_MESH, 2)
    # the sharded tier is ported: a mesh of 2 needs a world of 2 ranks
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        KMeans().fit(DataFrame.from_dict({"features": X}), device="cpu")
    # tensor parallelism is too: a 2 x 2 mesh needs a world of 4 ranks
    config.set(Options.TRAIN_MESH_MODEL, 2)
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        KMeans().fit(DataFrame.from_dict({"features": X}), device="cpu")


# ---------------------------------------------------------------------------
# KMeansModel: transform, model data, save/load both ways, CLASS_TABLE
# ---------------------------------------------------------------------------


def _model_pair(measure, d=D, k=K, seed=9):
    C = _uniform(k, d, seed=seed).astype(np.float64)
    weights = np.arange(1.0, k + 1.0)
    jmodel = JKMeansModel().set_k(k).set_distance_measure(measure)
    jmodel.centroids, jmodel.weights = C, weights
    model = KMeansModel().set_k(k).set_distance_measure(measure).set_model_data(*jmodel.get_model_data())
    return model, jmodel


@pytest.mark.parametrize("measure", MEASURES)
def test_model_transform_and_model_data_match_jax(measure):
    model, jmodel = _model_pair(measure)
    np.testing.assert_array_equal(model.centroids, jmodel.centroids)
    np.testing.assert_array_equal(model.weights, jmodel.weights)
    X = _uniform(N, D, seed=10)
    X[7] = np.nan
    out = model.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jmodel.transform(JDataFrame.from_dict({"features": X}))
    pred = out.column("prediction")
    assert pred.dtype == np.float64 and pred[7] == 0.0
    _assert_assignments(pred, np.asarray(ref.column("prediction")),
                        _decided(measure, X.astype(np.float32), model.centroids.astype(np.float32)), measure)
    back = JKMeansModel().set_model_data(*model.get_model_data())
    np.testing.assert_array_equal(back.centroids, jmodel.centroids)
    np.testing.assert_array_equal(back.weights, jmodel.weights)
    with pytest.raises(RuntimeError, match="fit/loaded"):
        KMeansModel().transform(DataFrame.from_dict({"features": X}), device="cpu")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    X = _blobs(300, D, K, seed=12)
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    scaler = StandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    jscaler = JStandardScaler().set_input_col("features").set_output_col("scaled").set_with_mean(True)
    sc_model = scaler.fit(df, device="cpu")
    km_model = (_configure(KMeans(), "euclidean").set_features_col("scaled")
                .fit(sc_model.transform(df, device="cpu"), device="cpu"))
    with mesh_context(MeshContext(n_data=1, n_model=1)):
        jsc_model = jscaler.fit(jdf)
        jkm_model = _configure(JKMeans(), "euclidean").set_features_col("scaled").fit(jsc_model.transform(jdf))
    root = tmp_path_factory.mktemp("kmeans")
    paths = {}
    for name, stage in (("sc", sc_model), ("km", km_model), ("jsc", jsc_model), ("jkm", jkm_model)):
        paths[name] = str(root / name)
        stage.save(paths[name])
    JPipelineModel([jsc_model, jkm_model]).save(str(root / "jpipe"))
    paths["jpipe"] = str(root / "jpipe")
    return paths, (sc_model, km_model, jsc_model, jkm_model), X


def test_jax_saved_models_load_into_the_port(saved):
    paths, (_, _, jsc_model, jkm_model), X = saved
    km = rw.load_stage(paths["jkm"])
    assert isinstance(km, KMeansModel)
    np.testing.assert_array_equal(km.centroids, jkm_model.centroids)
    np.testing.assert_array_equal(km.weights, jkm_model.weights)
    assert km.param_map_to_json() == jkm_model.param_map_to_json()
    pipe = load_servable(paths["jpipe"])
    assert [type(s) for s in pipe.servables] == [StandardScalerModelServable, KMeansModelServable]
    out = pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = JPipelineModel([jsc_model, jkm_model]).transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_array_equal(out.column("scaled"), np.asarray(ref.column("scaled")))
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))
    assert rw.resolve_class("flink_ml_tpu.servable.lib.KMeansModelServable") is KMeansModelServable
    assert rw.resolve_class("flink_ml_tpu.models.clustering.kmeans.KMeansModel") is KMeansModelServable
    assert rw.resolve_class("flink_ml_tpu.models.clustering.kmeans.KMeansModel", stage=True) is KMeansModel


def test_port_saved_models_load_into_the_jax_package(saved):
    paths, (sc_model, km_model, _, jkm_model), X = saved
    jpipe = JPipeline([jlib.StandardScalerModelServable.load_servable(paths["sc"]),
                       JKMeansModel.load_servable(paths["km"])])
    assert isinstance(jpipe.servables[1], jlib.KMeansModelServable)
    port_pipe = PipelineModelServable([load_servable(paths["sc"]), KMeansModel.load_servable(paths["km"])])
    assert isinstance(port_pipe.servables[1], KMeansModelServable)
    out = port_pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jpipe.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_array_equal(out.column("prediction"), np.asarray(ref.column("prediction")))
    direct = km_model.transform(sc_model.transform(DataFrame.from_dict({"features": X}), device="cpu"),
                                device="cpu")
    np.testing.assert_array_equal(out.column("prediction"), direct.column("prediction"))
    np.testing.assert_allclose(km_model.centroids, jkm_model.centroids, rtol=0, atol=CENTROID_ATOL)
    reloaded = KMeansModel.load(paths["km"])
    assert reloaded.param_map_to_json() == km_model.param_map_to_json()
    np.testing.assert_array_equal(reloaded.centroids, km_model.centroids)
    with pytest.raises(ValueError, match="does not match"):
        KMeansModel.load(paths["sc"])
    from_memory = servable_from_arrays(
        "flink_ml_tpu.models.clustering.kmeans.KMeansModel",
        km_model.param_map_to_json(), rw.load_model_arrays(paths["km"]),
    )
    np.testing.assert_array_equal(from_memory.weights, km_model.weights)
    np.testing.assert_array_equal(
        from_memory.transform(direct, device="cpu").column("prediction"), direct.column("prediction"))
    with pytest.raises(ValueError, match="needs model arrays"):
        servable_from_arrays("flink_ml_tpu.servable.lib.KMeansModelServable", {},
                             {"centroids": km_model.centroids})


# ---------------------------------------------------------------------------
# the servable and the serving plan against the JAX package
# ---------------------------------------------------------------------------


def _pipelines(measure, d=D, k=K, with_mean=True, with_std=True, seed=13):
    rng = np.random.default_rng(seed)
    mean, std = rng.random(d) * 0.5, rng.random(d) * 0.3 + 0.2
    std[1] = 0.0  # the zero-std guard
    C = rng.normal(size=(k, d)).astype(np.float32)

    def build(sc_cls, km_cls, pipe_cls):
        sc = sc_cls().set_input_col("features").set_output_col("scaled")
        sc.set_with_mean(with_mean)
        sc.set_with_std(with_std)
        sc.mean, sc.std = mean, std
        km = km_cls().set_features_col("scaled").set_k(k).set_distance_measure(measure)
        km.centroids, km.weights = C, np.ones(k)
        return pipe_cls([sc, km])

    return (
        build(StandardScalerModelServable, KMeansModelServable, PipelineModelServable),
        build(jlib.StandardScalerModelServable, jlib.KMeansModelServable, JPipeline),
    )


def _decided_after_scaling(measure, port_pipe, df_out):
    C = port_pipe.servables[-1].centroids
    return _decided(measure, np.asarray(df_out.column("scaled"), np.float32), C)


@pytest.mark.parametrize("measure", MEASURES)
def test_servable_matches_jax(measure):
    port_pipe, jax_pipe = _pipelines(measure)
    X = _uniform(177, D, seed=14)
    km, jkm = port_pipe.servables[1], jax_pipe.servables[1]
    assert km.param_map_to_json() == jkm.param_map_to_json()
    out = port_pipe.transform(DataFrame.from_dict({"features": X}), device="cpu")
    ref = jax_pipe.transform(JDataFrame.from_dict({"features": X}))
    np.testing.assert_array_equal(out.column("scaled"), np.asarray(ref.column("scaled")))
    _assert_assignments(out.column("prediction"), np.asarray(ref.column("prediction")),
                        _decided_after_scaling(measure, port_pipe, out), measure)
    assert out.column("prediction").dtype == np.float64
    spec, jspec = km.kernel_spec(), jkm.kernel_spec()
    assert spec.fusion_op == jspec.fusion_op == "kmeans"
    assert spec.fusion_params == {"distance_measure": measure}
    assert set(spec.model_arrays) == set(jspec.model_arrays) == {"centroids"}
    assert spec.model_arrays["centroids"].dtype == np.float32
    assert [(n, str(t)) for n, t in spec.outputs] == [(n, str(t)) for n, t in jspec.outputs]
    assert chain_eligible([port_pipe.servables[0].kernel_spec(), spec])
    with pytest.raises(RuntimeError, match="set_model_data"):
        KMeansModelServable().kernel_spec()


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("with_mean,with_std", FLAGS)
def test_plan_tiers_match_jax_exact_and_megakernel_tiers(measure, with_mean, with_std):
    """The port's exact tier equals its per-stage transform bit for bit, its
    fast tier's megakernel program (the plain version on CPU tensors) the
    per-stage transform too; both agree with the JAX exact plan and the JAX
    Pallas megakernel in interpret mode outside the tie margin."""
    port_pipe, jax_pipe = _pipelines(measure, with_mean=with_mean, with_std=with_std)
    n = 203  # odd: the JAX megakernel's single-tile tail path
    X = _uniform(n, D, seed=15)
    X[5] = np.nan
    df, jdf = DataFrame.from_dict({"features": X}), JDataFrame.from_dict({"features": X})
    per_stage = port_pipe.transform(df, device="cpu")
    tag = f"{measure}{int(with_mean)}{int(with_std)}"
    exact = CompiledServingPlan.build(port_pipe, scope=f"tkm-e{tag}", device="cpu").execute(df)
    mega_plan = CompiledServingPlan.build(port_pipe, scope=f"tkm-m{tag}", device="cpu",
                                          fusion=FusionTier("fast", min_score=1.0))
    mega = mega_plan.execute(df)
    assert chain_kinds(mega_plan) == {n: ("megakernel",)}
    j_exact = JPlan.build(jax_pipe, scope=f"tkmj-e{tag}").execute(jdf)
    j_plan = JPlan.build(jax_pipe, scope=f"tkmj-m{tag}", fusion=JFusionTier("fast", min_score=1.0))
    j_mega = j_plan.execute(jdf)
    assert "fast+mega" in {s.plan_label(n) for s in j_plan.segments}
    for name in ("scaled", "prediction"):
        np.testing.assert_array_equal(exact.column(name), per_stage.column(name))
        np.testing.assert_array_equal(mega.column(name), per_stage.column(name))
        assert mega.column(name).dtype == np.float64
    decided = _decided_after_scaling(measure, port_pipe, per_stage)
    assert decided[5] and mega.column("prediction")[5] == 0.0
    for ref, tier in ((j_exact, "exact"), (j_mega, "fast+mega")):
        np.testing.assert_array_equal(mega.column("scaled"), np.asarray(ref.column("scaled")), err_msg=tier)
        _assert_assignments(mega.column("prediction"), np.asarray(ref.column("prediction")), decided,
                            f"{tier} {tag}")


@pytest.mark.parametrize("measure", MEASURES)
def test_kmeans_alone_is_one_megakernel_chain(measure):
    port_pipe, jax_pipe = _pipelines(measure)
    km = port_pipe.servables[1].set_features_col("features")
    jax_pipe.servables[1].set_features_col("features")
    X = _uniform(33, D, seed=16)
    plan = CompiledServingPlan.build(km, scope=f"tkm-alone-{measure}", device="cpu",
                                     fusion=FusionTier("fast", min_score=1.0))
    out = plan.execute(DataFrame.from_dict({"features": X}))
    assert chain_kinds(plan) == {33: ("megakernel",)}
    ref = jax_pipe.servables[1].transform(JDataFrame.from_dict({"features": X}))
    _assert_assignments(out.column("prediction"), np.asarray(ref.column("prediction")),
                        _decided(measure, X, km.centroids), measure)
    np.testing.assert_array_equal(out.column("prediction"),
                                  km.transform(DataFrame.from_dict({"features": X}), device="cpu")
                                  .column("prediction"))


def test_cost_model_choice_per_bucket_equals_jax():
    """At the published width (d 100, k 10) the head scores 2·1000 + 8 +
    4·100 = 2408 per row and the chain behind the scaler 3016: against the
    default bar of 10^6 both run the megakernel from bucket 512, in both
    packages."""
    port_pipe, jax_pipe = _pipelines("euclidean", d=100, k=10)
    specs = [s.kernel_spec() for s in port_pipe.servables]
    jspecs = [s.kernel_spec() for s in jax_pipe.servables]
    assert chain_score(specs[1:], 1, width=100) == 2408
    assert chain_score(specs, 1, width=100) == 3016
    tier, jtier = FusionTier("fast"), JFusionTier("fast")
    for chain, jchain in ((specs[1:], jspecs[1:]), (specs, jspecs)):
        for bucket in (1 << i for i in range(13)):
            hot = tier.megakernel_hot(chain, bucket, 100)
            assert hot == jtier.megakernel_hot(jchain, bucket, 100) == (bucket >= 512), bucket
    # and the plans built by each package choose so
    for rows in (256, 512):
        X = _uniform(rows, 100, seed=rows)
        plan = CompiledServingPlan.build(port_pipe, scope=f"tkm-cost{rows}", device="cpu",
                                         fusion=FusionTier("fast"))
        plan.execute(DataFrame.from_dict({"features": X}))
        j_plan = JPlan.build(jax_pipe, scope=f"tkmj-cost{rows}", fusion=JFusionTier("fast"))
        j_plan.execute(JDataFrame.from_dict({"features": X}))
        want = ("megakernel",) if rows >= 512 else ("fused",)
        assert chain_kinds(plan) == {rows: want}
        assert {s.plan_label(rows) for s in j_plan.segments} == {"fast+mega" if rows >= 512 else "fast"}


def test_port_and_jax_servers_answer_the_same_stream():
    """Both servers under fusion.mode=fast with the bar lowered so buckets
    from 16 rows run the megakernel (the JAX one in interpret mode)."""
    port_pipe, jax_pipe = _pipelines("euclidean")
    per_row = chain_score([s.kernel_spec() for s in port_pipe.servables], 1, width=D)
    config.set(Options.FUSION_MEGAKERNEL_MIN_SCORE, per_row * 16)
    jconfig.set(JOptions.FUSION_MEGAKERNEL_MIN_SCORE, per_row * 16)
    rng = np.random.default_rng(17)
    sizes = [1, 3, 16, 9, 64, 33, 2]
    payloads = [rng.random((n, D)) for n in sizes]
    template = payloads[0][:1]
    port_cfg = ServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    jax_cfg = JServingConfig(max_batch_size=64, max_delay_ms=0.5, fusion_mode="fast")
    with InferenceServer(port_pipe, name="tkm-pair", serving_config=port_cfg, device="cpu",
                         warmup_template=DataFrame.from_dict({"features": template})) as port, \
            JServer(jax_pipe, name="tkm-pair-jax", serving_config=jax_cfg,
                    warmup_template=JDataFrame.from_dict({"features": template})) as ref:
        for i, x in enumerate(payloads):  # one request at a time: batching is deterministic
            a = port.predict(DataFrame.from_dict({"features": x}))
            b = ref.predict(JDataFrame.from_dict({"features": x}))
            assert a.bucket == b.bucket
            np.testing.assert_array_equal(a.dataframe.column("scaled"), np.asarray(b.dataframe.column("scaled")))
            _assert_assignments(a.dataframe.column("prediction"), np.asarray(b.dataframe.column("prediction")),
                                _decided_after_scaling("euclidean", port_pipe, a.dataframe), f"request {i}")
            want = port_pipe.transform(DataFrame.from_dict({"features": x}), device="cpu")
            np.testing.assert_array_equal(a.dataframe.column("prediction"), want.column("prediction"))
        j_kinds = {key: kinds for s in jax_pipe._fastpath_plan.segments
                   if hasattr(s, "plan_kinds") for key, kinds in s.plan_kinds.items()}
    kinds = chain_kinds(port_pipe._fastpath_plan)
    assert {b for b, k in kinds.items() if "megakernel" in k} == {16, 32, 64}
    assert {b for b, k in j_kinds.items() if "megakernel" in k} == {16, 32, 64}
    assert metrics.get(port.scope, MLMetrics.SERVING_FALLBACK_BATCHES, 0) == 0
    assert metrics.get(port.scope, MLMetrics.SERVING_FASTPATH_COMPILES, 0) == 0


# ---------------------------------------------------------------------------
# the wrapper's device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("measure", MEASURES)
def test_wrapper_runs_the_plain_version_for_cpu_tensors_without_counting(measure):
    rng = np.random.default_rng(21)
    x, mean, inv_std = _t(rng.random((40, D))), _t(rng.random(D)), _t(rng.random(D) + 0.5)
    C = _t(rng.random((K, D)))
    before = SCALE_KMEANS.launches
    for with_mean, with_std in ((True, True), (True, False), (False, True), (False, False)):
        kw = dict(measure=measure, with_mean=with_mean, with_std=with_std)
        got = scale_kmeans(x, mean, inv_std, C, write_scaled=True, **kw)
        want = scale_kmeans_plain(x, mean, inv_std, C, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[1].dtype == torch.int32
    none, pred = scale_kmeans(x, None, None, C, measure=measure, with_mean=False, with_std=False,
                              write_scaled=False)
    assert none is None and pred.shape == (40,) and set(pred.tolist()) <= set(range(K))
    assert SCALE_KMEANS.launches == before  # the count is of kernel launches only


def test_wrapper_raises_for_what_it_has_no_path_for():
    C = torch.empty((K, D), device="meta")
    with pytest.raises(RuntimeError, match="needs CPU or CUDA tensors"):
        scale_kmeans(torch.empty((4, D), device="meta"), None, None, C, measure="euclidean",
                     with_mean=False, with_std=False, write_scaled=False)
    with pytest.raises(ValueError, match="has measures"):
        scale_kmeans(torch.zeros((4, D)), None, None, torch.zeros((K, D)), measure="chebyshev",
                     with_mean=False, with_std=False, write_scaled=False)
    assert KMEANS_MAX_K >= 64 and KMEANS_MAX_DIM >= 256  # the published model and the card's grid fit
