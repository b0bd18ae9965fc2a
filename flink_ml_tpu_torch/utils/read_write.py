"""Stage persistence: JSON metadata + array model data.

Twin of ``flink_ml_tpu/utils/read_write.py`` with the same on-disk contract:
``<path>/metadata`` is JSON ``{className, timestamp, paramMap, ...}`` and model
data is one ``<path>/data/model_data.npz`` of named arrays. A directory the
JAX package saved loads here and the reverse.

Class dispatch differs: the saved ``className`` of a JAX-written directory
names a class of ``flink_ml_tpu``, which the port must never import. So
:data:`CLASS_TABLE` maps each such name to the port classes that load it, and
:func:`resolve_class` imports only from this package.
"""
from __future__ import annotations

import importlib
import json
import os
import time
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

__all__ = [
    "CLASS_TABLE",
    "save_metadata",
    "load_metadata",
    "save_model_arrays",
    "load_model_arrays",
    "load_stage",
    "resolve_class",
    "stage_class_name",
    "model_data_path",
]

_METADATA_FILE = "metadata"
_DATA_DIR = "data"
_ARRAYS_FILE = "model_data.npz"
_PORT_PACKAGE = "flink_ml_tpu_torch."

_PIPELINE = "flink_ml_tpu_torch.servable.builder.PipelineModelServable"
_SCALER = "flink_ml_tpu_torch.servable.lib.StandardScalerModelServable"
_LOGISTIC = "flink_ml_tpu_torch.servable.lib.LogisticRegressionModelServable"
_LOGISTIC_MODEL = "flink_ml_tpu_torch.models.classification.logistic_regression.LogisticRegressionModel"
_IDF_MODEL = "flink_ml_tpu_torch.models.feature.idf.IDFModel"
_SCALER_MODEL = "flink_ml_tpu_torch.models.feature.standard_scaler.StandardScalerModel"
_MLP = "flink_ml_tpu_torch.servable.lib.MLPClassifierModelServable"
_MLP_MODEL = "flink_ml_tpu_torch.models.classification.mlp_classifier.MLPClassifierModel"
_KMEANS = "flink_ml_tpu_torch.servable.lib.KMeansModelServable"
_KMEANS_MODEL = "flink_ml_tpu_torch.models.clustering.kmeans.KMeansModel"

#: Saved ``className`` of the JAX package → (the port servable that loads it
#: with ``load_servable(path)``, the port training-side stage that loads it
#: with ``load(path)`` or None where that stage is not ported). Training-side
#: Models load as their runtime-free servables, as the JAX package's
#: ``load_servable`` hooks do (``pipeline.py:194``, ``standard_scaler.py:154``,
#: ``logistic_regression.py:30``, ``mlp_classifier.py:195``,
#: ``kmeans.py:215``). The reverse direction needs no table: the JAX package
#: reads a port-written directory through its servables' ``load_servable``,
#: which ignore the class name.
CLASS_TABLE: Dict[str, Tuple[str, Optional[str]]] = {
    "flink_ml_tpu.builder.pipeline.PipelineModel": (_PIPELINE, None),
    "flink_ml_tpu.servable.builder.PipelineModelServable": (_PIPELINE, None),
    "flink_ml_tpu.models.feature.standard_scaler.StandardScalerModel": (_SCALER, _SCALER_MODEL),
    "flink_ml_tpu.servable.lib.StandardScalerModelServable": (_SCALER, None),
    "flink_ml_tpu.models.classification.logistic_regression.LogisticRegressionModel":
        (_LOGISTIC, _LOGISTIC_MODEL),
    "flink_ml_tpu.servable.lib.LogisticRegressionModelServable": (_LOGISTIC, None),
    "flink_ml_tpu.models.classification.mlp_classifier.MLPClassifierModel": (_MLP, _MLP_MODEL),
    "flink_ml_tpu.servable.lib.MLPClassifierModelServable": (_MLP, None),
    "flink_ml_tpu.models.clustering.kmeans.KMeansModel": (_KMEANS, _KMEANS_MODEL),
    "flink_ml_tpu.servable.lib.KMeansModelServable": (_KMEANS, None),
    # IDFModel is its own servable in both packages (``idf.py``).
    "flink_ml_tpu.models.feature.idf.IDFModel": (_IDF_MODEL, _IDF_MODEL),
}


def stage_class_name(stage: Any) -> str:
    cls = type(stage) if not isinstance(stage, type) else stage
    return f"{cls.__module__}.{cls.__qualname__}"


def save_metadata(stage, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``<path>/metadata``. Fails if the path already has metadata."""
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, _METADATA_FILE)
    if os.path.exists(meta_path):
        raise IOError(f"File {meta_path} already exists")
    metadata = dict(extra or {})
    metadata["className"] = stage_class_name(stage)
    metadata["timestamp"] = int(time.time() * 1000)
    metadata["paramMap"] = stage.param_map_to_json()
    with open(meta_path, "w") as f:
        json.dump(metadata, f, indent=2, sort_keys=True)


def load_metadata(path: str, expected_class_name: str = "") -> Dict[str, Any]:
    """Read ``<path>/metadata``; with ``expected_class_name`` (a port
    stage's), raise ``ValueError`` unless the saved class name is it or a
    JAX name whose :data:`CLASS_TABLE` stage is it."""
    with open(os.path.join(path, _METADATA_FILE)) as f:
        metadata = json.load(f)
    name = metadata["className"]
    if expected_class_name and expected_class_name not in (name, CLASS_TABLE.get(name, (None, None))[1]):
        raise ValueError(f"Class name {name} does not match the expected {expected_class_name}")
    return metadata


def load_stage(path: str):
    """Load a saved training-side stage — written by either package — as
    the port stage its class name resolves to."""
    return resolve_class(load_metadata(path)["className"], stage=True).load(path)


def resolve_class(class_name: str, stage: bool = False) -> Type:
    """The port class for a saved ``className``: through :data:`CLASS_TABLE`
    for names the JAX package wrote (its servable, or with ``stage`` its
    training-side stage), directly for the port's own names. Anything else
    raises ``ValueError`` naming the class — the port has no counterpart
    for it yet."""
    entry = CLASS_TABLE.get(class_name)
    target = class_name if entry is None else entry[1] if stage else entry[0]
    if target is None or not target.startswith(_PORT_PACKAGE):
        kind = "stage" if stage else "class"
        raise ValueError(f"no port {kind} loads a saved {class_name!r}")
    module_name, _, qualname = target.rpartition(".")
    obj = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def model_data_path(path: str) -> str:
    return os.path.join(path, _DATA_DIR)


def save_model_arrays(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Model data as one npz of named arrays under ``<path>/data/``."""
    data_dir = model_data_path(path)
    os.makedirs(data_dir, exist_ok=True)
    np.savez_compressed(os.path.join(data_dir, _ARRAYS_FILE), **arrays)


def load_model_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(model_data_path(path), _ARRAYS_FILE), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
