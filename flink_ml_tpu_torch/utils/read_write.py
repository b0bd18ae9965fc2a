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
import pickle
import time
import zipfile
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
    "jax_class_name",
    "model_data_path",
    "save_column_arrays",
    "load_column_arrays",
]

_METADATA_FILE = "metadata"
_DATA_DIR = "data"
_ARRAYS_FILE = "model_data.npz"
_PORT_PACKAGE = "flink_ml_tpu_torch."
_JAX_PACKAGE = "flink_ml_tpu."

_PIPELINE = "flink_ml_tpu_torch.servable.builder.PipelineModelServable"
_PIPELINE_MODEL = "flink_ml_tpu_torch.builder.pipeline.PipelineModel"
_PIPELINE_ESTIMATOR = "flink_ml_tpu_torch.builder.pipeline.Pipeline"
_SCALER = "flink_ml_tpu_torch.servable.lib.StandardScalerModelServable"
_LOGISTIC = "flink_ml_tpu_torch.servable.lib.LogisticRegressionModelServable"
_LOGISTIC_MODEL = "flink_ml_tpu_torch.models.classification.logistic_regression.LogisticRegressionModel"
_IDF_MODEL = "flink_ml_tpu_torch.models.feature.idf.IDFModel"
_SCALER_MODEL = "flink_ml_tpu_torch.models.feature.standard_scaler.StandardScalerModel"
_MLP = "flink_ml_tpu_torch.servable.lib.MLPClassifierModelServable"
_MLP_MODEL = "flink_ml_tpu_torch.models.classification.mlp_classifier.MLPClassifierModel"
_KMEANS = "flink_ml_tpu_torch.servable.lib.KMeansModelServable"
_KMEANS_MODEL = "flink_ml_tpu_torch.models.clustering.kmeans.KMeansModel"
_NORMALIZER = "flink_ml_tpu_torch.models.feature.normalizer.Normalizer"
_PRODUCT = "flink_ml_tpu_torch.models.feature.elementwise_product.ElementwiseProduct"
_BINARIZER = "flink_ml_tpu_torch.models.feature.binarizer.Binarizer"
_IMPUTER = "flink_ml_tpu_torch.models.feature.imputer.Imputer"
_IMPUTER_MODEL = "flink_ml_tpu_torch.models.feature.imputer.ImputerModel"
_ATTN_MODEL = "flink_ml_tpu_torch.models.classification.attention_classifier.SelfAttentionClassifierModel"
_ATTN = "flink_ml_tpu_torch.models.classification.attention_classifier.SelfAttentionClassifier"
_SCALER_EST = "flink_ml_tpu_torch.models.feature.standard_scaler.StandardScaler"
_KMEANS_EST = "flink_ml_tpu_torch.models.clustering.kmeans.KMeans"
_MLP_EST = "flink_ml_tpu_torch.models.classification.mlp_classifier.MLPClassifier"
_LOGISTIC_EST = "flink_ml_tpu_torch.models.classification.logistic_regression.LogisticRegression"
_IDF_EST = "flink_ml_tpu_torch.models.feature.idf.IDF"
_SVC_MODEL = "flink_ml_tpu_torch.models.classification.linearsvc.LinearSVCModel"
_SVC_EST = "flink_ml_tpu_torch.models.classification.linearsvc.LinearSVC"
_LINREG_MODEL = "flink_ml_tpu_torch.models.regression.linear_regression.LinearRegressionModel"
_LINREG_EST = "flink_ml_tpu_torch.models.regression.linear_regression.LinearRegression"
_TOKENIZER = "flink_ml_tpu_torch.models.feature.tokenizer.Tokenizer"
_REGEX_TOKENIZER = "flink_ml_tpu_torch.models.feature.tokenizer.RegexTokenizer"
_STOP_WORDS = "flink_ml_tpu_torch.models.feature.stop_words_remover.StopWordsRemover"
_NGRAM = "flink_ml_tpu_torch.models.feature.ngram.NGram"
_HASHING_TF = "flink_ml_tpu_torch.models.feature.hashing_tf.HashingTF"
_FEATURE_HASHER = "flink_ml_tpu_torch.models.feature.feature_hasher.FeatureHasher"
_CV_MODEL = "flink_ml_tpu_torch.models.feature.count_vectorizer.CountVectorizerModel"
_CV_EST = "flink_ml_tpu_torch.models.feature.count_vectorizer.CountVectorizer"
_ONLINE_LR_MODEL = "flink_ml_tpu_torch.models.classification.online_logistic_regression.OnlineLogisticRegressionModel"
_ONLINE_LR = "flink_ml_tpu_torch.models.classification.online_logistic_regression.OnlineLogisticRegression"
_ONLINE_KMEANS_MODEL = "flink_ml_tpu_torch.models.clustering.online_kmeans.OnlineKMeansModel"
_ONLINE_KMEANS = "flink_ml_tpu_torch.models.clustering.online_kmeans.OnlineKMeans"
_ONLINE_SCALER_MODEL = "flink_ml_tpu_torch.models.feature.standard_scaler.OnlineStandardScalerModel"
_ONLINE_SCALER = "flink_ml_tpu_torch.models.feature.standard_scaler.OnlineStandardScaler"

#: Saved ``className`` of the JAX package → (the port servable that loads it
#: with ``load_servable(path)``, or None for an Estimator, which serves
#: nothing; the port training-side stage that loads it with ``load(path)``
#: or None where that stage is not ported). Training-side
#: Models load as their runtime-free servables, as the JAX package's
#: ``load_servable`` hooks do (``pipeline.py:194``, ``standard_scaler.py:154``,
#: ``logistic_regression.py:30``, ``mlp_classifier.py:195``,
#: ``kmeans.py:215``), a PipelineModel as the chain of its stages'
#: servables. The reverse direction needs no table: the port writes the
#: JAX twin's name (:func:`jax_class_name`, a key of this table), which the
#: JAX package's ``load`` and ``load_stage`` resolve themselves.
CLASS_TABLE: Dict[str, Tuple[Optional[str], Optional[str]]] = {
    "flink_ml_tpu.builder.pipeline.PipelineModel": (_PIPELINE, _PIPELINE_MODEL),
    "flink_ml_tpu.builder.pipeline.Pipeline": (None, _PIPELINE_ESTIMATOR),
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
    # IDFModel is its own servable in both packages (``idf.py``), and so
    # are the stateless Transformers (``api/core.py`` ``load_servable``) and,
    # in the port, ImputerModel.
    "flink_ml_tpu.models.feature.idf.IDFModel": (_IDF_MODEL, _IDF_MODEL),
    "flink_ml_tpu.models.feature.normalizer.Normalizer": (_NORMALIZER, _NORMALIZER),
    "flink_ml_tpu.models.feature.elementwise_product.ElementwiseProduct": (_PRODUCT, _PRODUCT),
    "flink_ml_tpu.models.feature.binarizer.Binarizer": (_BINARIZER, _BINARIZER),
    "flink_ml_tpu.models.feature.imputer.ImputerModel": (_IMPUTER_MODEL, _IMPUTER_MODEL),
    "flink_ml_tpu.models.feature.imputer.Imputer": (None, _IMPUTER),
    # The text stages: the stateless ones and CountVectorizerModel are their
    # own servables in both packages (``count_vectorizer.py:218``).
    "flink_ml_tpu.models.feature.tokenizer.Tokenizer": (_TOKENIZER, _TOKENIZER),
    "flink_ml_tpu.models.feature.tokenizer.RegexTokenizer": (_REGEX_TOKENIZER, _REGEX_TOKENIZER),
    "flink_ml_tpu.models.feature.stop_words_remover.StopWordsRemover": (_STOP_WORDS, _STOP_WORDS),
    "flink_ml_tpu.models.feature.ngram.NGram": (_NGRAM, _NGRAM),
    "flink_ml_tpu.models.feature.hashing_tf.HashingTF": (_HASHING_TF, _HASHING_TF),
    "flink_ml_tpu.models.feature.feature_hasher.FeatureHasher": (_FEATURE_HASHER, _FEATURE_HASHER),
    "flink_ml_tpu.models.feature.count_vectorizer.CountVectorizerModel": (_CV_MODEL, _CV_MODEL),
    "flink_ml_tpu.models.feature.count_vectorizer.CountVectorizer": (None, _CV_EST),
    # The Estimators a saved Pipeline holds load as the port's Estimators.
    "flink_ml_tpu.models.feature.standard_scaler.StandardScaler": (None, _SCALER_EST),
    "flink_ml_tpu.models.clustering.kmeans.KMeans": (None, _KMEANS_EST),
    "flink_ml_tpu.models.classification.mlp_classifier.MLPClassifier": (None, _MLP_EST),
    "flink_ml_tpu.models.classification.logistic_regression.LogisticRegression": (None, _LOGISTIC_EST),
    "flink_ml_tpu.models.feature.idf.IDF": (None, _IDF_EST),
    # The JAX package has no servable for the attention model, LinearSVC or
    # LinearRegression: each loads as the stage only.
    "flink_ml_tpu.models.classification.attention_classifier.SelfAttentionClassifierModel":
        (None, _ATTN_MODEL),
    "flink_ml_tpu.models.classification.attention_classifier.SelfAttentionClassifier": (None, _ATTN),
    "flink_ml_tpu.models.classification.linearsvc.LinearSVCModel": (None, _SVC_MODEL),
    "flink_ml_tpu.models.classification.linearsvc.LinearSVC": (None, _SVC_EST),
    "flink_ml_tpu.models.regression.linear_regression.LinearRegressionModel": (None, _LINREG_MODEL),
    "flink_ml_tpu.models.regression.linear_regression.LinearRegression": (None, _LINREG_EST),
    # The online stages: a published OnlineLogisticRegressionModel serves as
    # the batch model's servable (JAX ``online_logistic_regression.py``
    # ``load_servable``); the JAX package gives the other two models no
    # servable, so they load as the stage only.
    "flink_ml_tpu.models.classification.online_logistic_regression.OnlineLogisticRegressionModel":
        (_LOGISTIC, _ONLINE_LR_MODEL),
    "flink_ml_tpu.models.classification.online_logistic_regression.OnlineLogisticRegression": (None, _ONLINE_LR),
    "flink_ml_tpu.models.clustering.online_kmeans.OnlineKMeansModel": (None, _ONLINE_KMEANS_MODEL),
    "flink_ml_tpu.models.clustering.online_kmeans.OnlineKMeans": (None, _ONLINE_KMEANS),
    "flink_ml_tpu.models.feature.standard_scaler.OnlineStandardScalerModel": (None, _ONLINE_SCALER_MODEL),
    "flink_ml_tpu.models.feature.standard_scaler.OnlineStandardScaler": (None, _ONLINE_SCALER),
}


def stage_class_name(stage: Any) -> str:
    cls = type(stage) if not isinstance(stage, type) else stage
    return f"{cls.__module__}.{cls.__qualname__}"


def jax_class_name(stage: Any) -> str:
    """The saved ``className`` of a port stage: its JAX twin's, the port
    class's path with ``flink_ml_tpu_torch.`` read as ``flink_ml_tpu.``.
    Raises ``ValueError`` naming the class when that name is not a key of
    :data:`CLASS_TABLE` (the JAX package has no such stage, or the port
    could not read the directory back)."""
    name = stage_class_name(stage)
    twin = _JAX_PACKAGE + name[len(_PORT_PACKAGE):] if name.startswith(_PORT_PACKAGE) else name
    if twin not in CLASS_TABLE:
        raise ValueError(f"{name} has no JAX twin in CLASS_TABLE: it cannot be saved")
    return twin


def save_metadata(stage, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write ``<path>/metadata`` under the JAX twin's class name
    (:func:`jax_class_name`). Fails if the path already has metadata."""
    os.makedirs(path, exist_ok=True)
    meta_path = os.path.join(path, _METADATA_FILE)
    if os.path.exists(meta_path):
        raise IOError(f"File {meta_path} already exists")
    metadata = dict(extra or {})
    metadata["className"] = jax_class_name(stage)
    metadata["timestamp"] = int(time.time() * 1000)
    metadata["paramMap"] = stage.param_map_to_json()
    with open(meta_path, "w") as f:
        json.dump(metadata, f, indent=2, sort_keys=True)


def load_metadata(path: str, expected_class_name: str = "") -> Dict[str, Any]:
    """Read ``<path>/metadata``; with ``expected_class_name`` (a port
    stage's), raise ``ValueError`` unless the saved class name is a JAX
    name whose :data:`CLASS_TABLE` stage is it, or is it itself (a
    directory that holds the port's name)."""
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


# --- columns whose cells are vectors ------------------------------------------
#
# A column of Vector cells (an online scaler's buffered rows) is an object
# array, which an npz stores pickled. A pickle names each cell's class, and
# the JAX package's names a class of ``flink_ml_tpu``, which the port must
# never import. So the port pickles its vectors under their JAX twins' names
# (``flink_ml_tpu.linalg.vectors``: the same slots, the same state) without
# importing them, and unpickles either package's names as its own vectors
# and refuses any other ``flink_ml_tpu`` class.

_VECTORS_MODULES = ("flink_ml_tpu.linalg.vectors", "flink_ml_tpu_torch.linalg.vectors")
_VECTOR_CLASSES = ("DenseVector", "SparseVector")


class _TwinPickler(pickle._Pickler):
    """Pickles the port's vector classes by their JAX twins' names."""

    def save_global(self, obj, name=None):
        if getattr(obj, "__module__", None) == _VECTORS_MODULES[1] and obj.__qualname__ in _VECTOR_CLASSES:
            self.write(pickle.GLOBAL + f"{_VECTORS_MODULES[0]}\n{obj.__qualname__}\n".encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _TwinUnpickler(pickle.Unpickler):
    """Reads either package's vectors as the port's."""

    def find_class(self, module, name):
        if module in _VECTORS_MODULES and name in _VECTOR_CLASSES:
            from flink_ml_tpu_torch.linalg import vectors

            return getattr(vectors, name)
        if module.split(".")[0] in ("flink_ml_tpu", "flink_ml_tpu_torch"):
            raise pickle.UnpicklingError(f"{module}.{name} is not read from a column file")
        return super().find_class(module, name)


def save_column_arrays(path: str, columns: Dict[str, np.ndarray]) -> None:
    """An npz of named column arrays, as ``np.savez`` writes it; an object
    column's cells pickled under the JAX package's vector class names."""
    from numpy.lib import format as npy

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in columns.items():
            arr = np.asanyarray(arr)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                if arr.dtype.hasobject:
                    npy.write_array_header_1_0(f, npy.header_data_from_array_1_0(arr))
                    _TwinPickler(f, protocol=3).dump(arr)
                else:
                    npy.write_array(f, arr, allow_pickle=False)


def load_column_arrays(path: str) -> Dict[str, np.ndarray]:
    """The named columns of an npz either package wrote (:func:`save_column_arrays`,
    or ``np.savez`` of the JAX package), in the file's order."""
    from numpy.lib import format as npy

    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf:
        for member in zf.namelist():
            with zf.open(member) as f:
                version = npy.read_magic(f)
                read_header = npy.read_array_header_1_0 if version == (1, 0) else npy.read_array_header_2_0
                _shape, _fortran, dtype = read_header(f)
                if dtype.hasobject:
                    arr = _TwinUnpickler(f).load()
                else:
                    with zf.open(member) as g:
                        arr = npy.read_array(g, allow_pickle=False)
            out[member[: -len(".npy")] if member.endswith(".npy") else member] = arr
    return out
