"""The PyTorch port's core against the JAX package: import hygiene, the
device policy of its entry points, and the framework-free modules (DataFrame,
params, config and metric names, persistence, the ulp metric) on the same
numpy inputs."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flink_ml_tpu.api.dataframe as jdf
import flink_ml_tpu.config as jconfig
import flink_ml_tpu.metrics as jmetrics
import flink_ml_tpu.servable.fusion as jfusion
import flink_ml_tpu.servable.lib as jlib
import flink_ml_tpu_torch.config as tconfig
import flink_ml_tpu_torch.metrics as tmetrics
import flink_ml_tpu_torch.servable.fusion as tfusion
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.models.classification.mlp_classifier import MLPClassifier, MLPClassifierModel
from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel
from flink_ml_tpu_torch.models.feature.standard_scaler import StandardScaler, StandardScalerModel
from flink_ml_tpu_torch.servable import (
    KMeansModelServable,
    LogisticRegressionModelServable,
    MLPClassifierModelServable,
    PipelineModelServable,
    StandardScalerModelServable,
    servable_from_arrays,
)
from flink_ml_tpu_torch.serving import InferenceServer
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan
from flink_ml_tpu_torch.utils import read_write as rw

# Tiny shapes: one intra-op thread keeps torch from competing with the
# other test workers for cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "flink_ml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flink_ml_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [
        f"{f.relative_to(REPO)}:{line} imports {root}"
        for f in files
        for root, line in _imported_roots(f)
        if root in FORBIDDEN
    ]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import flink_ml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('flink_ml_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
    assert int(out.stdout.split()[1]) >= 20


# ---------------------------------------------------------------------------
# device policy: the entry points run on the card or raise
# ---------------------------------------------------------------------------


def _pipeline(d=8, seed=3):
    rng = np.random.default_rng(seed)
    sc = StandardScalerModelServable().set_input_col("features").set_output_col("scaled")
    sc.set_with_mean(True)
    sc.mean = rng.normal(size=d)
    sc.std = np.abs(rng.normal(size=d)) + 0.5
    lr = LogisticRegressionModelServable().set_features_col("scaled")
    lr.coefficient = rng.normal(size=d)
    return PipelineModelServable([sc, lr])


def _mlp_arrays(d=8):
    return {"W0": np.ones((d, 4)), "b0": np.zeros(4), "labels": np.arange(4.0)}


def _mlp_model(d=8):
    model = MLPClassifierModel()
    model.params, model.labels = [(np.ones((d, 4), np.float32), np.zeros(4, np.float32))], np.arange(4.0)
    return model


_FEATURES = DataFrame.from_dict({"features": np.zeros((2, 8)), "label": np.array([0.0, 1.0])})


@pytest.mark.parametrize(
    "entry",
    [
        lambda: InferenceServer(),
        lambda: InferenceServer(_pipeline(), serving_config=None),
        lambda: CompiledServingPlan.build(_pipeline()),
        lambda: _pipeline().transform(DataFrame.from_dict({"features": np.zeros((2, 8))})),
        lambda: resolve_device("cuda"),
        lambda: MLPClassifier().fit(_FEATURES),
        lambda: _mlp_model().transform(_FEATURES),
        lambda: StandardScaler().set_input_col("features").fit(_FEATURES),
        lambda: MLPClassifierModelServable()._apply_model_arrays(_mlp_arrays()).transform(_FEATURES),
    ],
    ids=["server", "server-with-model", "plan", "transform", "resolve", "mlp-fit", "mlp-transform",
         "scaler-fit", "mlp-servable"],
)
def test_default_device_is_cuda_and_raises_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_cpu_is_explicit_and_other_devices_are_refused():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


# ---------------------------------------------------------------------------
# DataFrame, params, options, metric names: same behaviour as the JAX package
# ---------------------------------------------------------------------------


def test_dataframe_operations_match_the_jax_package():
    rng = np.random.default_rng(0)
    data = {"features": rng.normal(size=(9, 5)), "id": np.arange(9)}
    a, b = DataFrame.from_dict(data), jdf.DataFrame.from_dict(data)
    idx = [8, 0, 0, 3]
    pairs = [
        (a, b),
        (a.take(idx), b.take(idx)),
        (a.take(np.arange(9) % 2 == 0), b.take(np.arange(9) % 2 == 0)),
        (DataFrame.concat([a, a.take([1])]), jdf.DataFrame.concat([b, b.take([1])])),
        (a.clone().add_column("y", None, np.ones(9)), b.clone().add_column("y", None, np.ones(9))),
    ]
    for p, j in pairs:
        assert len(p) == len(j)
        assert p.get_column_names() == j.get_column_names()
        for name in p.get_column_names():
            np.testing.assert_array_equal(p.column(name), j.column(name))
        np.testing.assert_array_equal(p.vectors("features"), j.vectors("features"))
        assert repr(p.get_data_types()) == repr(j.get_data_types())


def test_servable_params_encode_like_the_jax_package():
    port = StandardScalerModelServable().set_input_col("x").set_output_col("y").set_with_mean(True)
    ref = jlib.StandardScalerModelServable().set_input_col("x").set_output_col("y").set_with_mean(True)
    assert port.param_map_to_json() == ref.param_map_to_json()
    port_lr = LogisticRegressionModelServable().set_features_col("s")
    ref_lr = jlib.LogisticRegressionModelServable().set_features_col("s")
    assert port_lr.param_map_to_json() == ref_lr.param_map_to_json()


def test_config_options_share_keys_defaults_and_env_names():
    port = tconfig.Options.all()
    ref = jconfig.Options.all()
    assert set(port) == {
        "serving.max.batch.size", "serving.max.delay.ms", "serving.queue.capacity.rows",
        "serving.default.timeout.ms", "serving.fastpath", "serving.pipeline.depth",
        "serving.poll.interval.ms", "serving.poll.backoff.max.ms",
        "serving.mesh", "serving.mesh.model", "mesh.data.axis.size", "mesh.model.axis.size",
        "fusion.mode", "fusion.megakernel", "fusion.megakernel.min.score",
        "sparse.fastpath", "sparse.nnz.cap.max", "sparse.warmup.caps",
        "batch.fastpath", "batch.chunk.rows", "batch.prefetch.depth", "batch.mesh", "batch.mesh.model",
        "train.mesh", "train.mesh.model", "train.mesh.hosts",
        "datacache.spill.dir", "datacache.memory.budget.bytes", "train.stream.window.rows",
        "native.datacache.enabled",
    }
    for key, opt in port.items():
        assert opt.default == ref[key].default, key
        assert opt.env_var == ref[key].env_var, key


def test_metric_names_are_the_jax_package_names():
    names = {k: v for k, v in vars(tmetrics.MLMetrics).items() if k.isupper() and isinstance(v, str)}
    assert len(names) > 20
    for attr, value in names.items():
        assert getattr(jmetrics.MLMetrics, attr) == value, attr
    assert tmetrics.MLMetrics.fallback_reason("serving", "signature") == (
        jmetrics.MLMetrics.fallback_reason("serving", "signature")
    )


def test_ulp_metric_and_envelopes_match_the_jax_package():
    assert tfusion.ULP_ENVELOPE == jfusion.ULP_ENVELOPE
    rng = np.random.default_rng(1)
    a = rng.normal(size=500).astype(np.float32)
    for b in (a, np.nextafter(a, np.float32(np.inf)), a * np.float32(1.001), -a, np.zeros_like(a)):
        assert tfusion.ulp_diff(a, b) == jfusion.ulp_diff(a, b)
    nan = a.copy()
    nan[3] = np.nan
    assert tfusion.ulp_diff(a, nan) == jfusion.ulp_diff(a, nan)
    assert tfusion.ulp_diff(np.float32([0.0]), np.float32([-0.0])) == 0


# ---------------------------------------------------------------------------
# persistence and the class-name table
# ---------------------------------------------------------------------------


def test_class_table_maps_jax_names_to_port_classes():
    assert rw.resolve_class("flink_ml_tpu.builder.pipeline.PipelineModel") is PipelineModelServable
    assert (
        rw.resolve_class("flink_ml_tpu.models.feature.standard_scaler.StandardScalerModel")
        is StandardScalerModelServable
    )
    assert (
        rw.resolve_class(
            "flink_ml_tpu.models.classification.logistic_regression.LogisticRegressionModel"
        )
        is LogisticRegressionModelServable
    )
    assert rw.resolve_class(rw.stage_class_name(StandardScalerModelServable)) is StandardScalerModelServable
    mlp = "flink_ml_tpu.models.classification.mlp_classifier.MLPClassifierModel"
    assert rw.resolve_class(mlp) is MLPClassifierModelServable
    assert rw.resolve_class(mlp, stage=True) is MLPClassifierModel
    assert rw.resolve_class("flink_ml_tpu.servable.lib.MLPClassifierModelServable") is MLPClassifierModelServable
    scaler = "flink_ml_tpu.models.feature.standard_scaler.StandardScalerModel"
    assert rw.resolve_class(scaler, stage=True) is StandardScalerModel
    kmeans = "flink_ml_tpu.models.clustering.kmeans.KMeansModel"
    assert rw.resolve_class(kmeans) is KMeansModelServable
    assert rw.resolve_class(kmeans, stage=True) is KMeansModel
    assert rw.resolve_class("flink_ml_tpu.servable.lib.KMeansModelServable") is KMeansModelServable
    with pytest.raises(ValueError, match="no port class"):
        rw.resolve_class("flink_ml_tpu.models.clustering.agglomerative_clustering.AgglomerativeClustering")


def test_saved_port_stage_round_trips(tmp_path):
    sc = _pipeline().servables[0]
    path = str(tmp_path / "scaler")
    rw.save_metadata(sc, path)
    rw.save_model_arrays(path, {"mean": sc.mean, "std": sc.std})
    from flink_ml_tpu_torch.servable import load_servable

    loaded = load_servable(path)
    assert isinstance(loaded, StandardScalerModelServable)
    assert loaded.param_map_to_json() == sc.param_map_to_json()
    np.testing.assert_array_equal(loaded.mean, sc.mean)
    with pytest.raises(IOError):
        rw.save_metadata(sc, path)


def test_servable_from_arrays_validates_its_inputs():
    with pytest.raises(ValueError, match="needs model arrays"):
        servable_from_arrays(
            "flink_ml_tpu.servable.lib.LogisticRegressionModelServable", {}, {}
        )
    with pytest.raises(ValueError, match="not a single model stage"):
        servable_from_arrays("flink_ml_tpu.builder.pipeline.PipelineModel", {}, {})
    lr = servable_from_arrays(
        "flink_ml_tpu.models.classification.logistic_regression.LogisticRegressionModel",
        {"featuresCol": "f", "maxIter": 5},  # a training-only param is skipped
        {"coefficient": np.ones(3)},
    )
    assert lr.get_features_col() == "f"
    np.testing.assert_array_equal(lr.coefficient, np.ones(3))
