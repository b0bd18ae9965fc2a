"""Shared model-building infrastructure — twin of ``flink_ml_tpu/models/common.py``.

``extract_labeled_data`` pulls whole columns out of a DataFrame (the
reference's LabeledPointWithWeight boundary, minus the per-row object);
``ModelArraysMixin`` gives models whose state is named arrays their
save/load and model-data DataFrame.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.linalg.vectors import DenseVector, Vector
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["extract_labeled_data", "ModelArraysMixin"]


def extract_labeled_data(
    df: DataFrame,
    features_col: str,
    label_col: Optional[str],
    weight_col: Optional[str],
    dtype=np.float32,
    allow_sparse: bool = False,
) -> Dict[str, np.ndarray]:
    """DataFrame → columnar ``{features [n, d], labels [n], weights [n]}``.
    With ``allow_sparse`` and a SparseVector column, features come out in
    padded CSR instead — ``indices``/``values`` [n, K] plus ``dim`` — so
    wide sparse training never densifies."""
    if allow_sparse and df.is_sparse(features_col):
        batch = df.sparse_batch(features_col)
        out = {"indices": batch.indices, "values": batch.values.astype(dtype), "dim": batch.dim}
        n = batch.n
    else:
        out = {"features": df.vectors(features_col).astype(dtype)}
        n = out["features"].shape[0]
    if label_col:
        out["labels"] = df.scalars(label_col, dtype)
    out["weights"] = df.scalars(weight_col, dtype) if weight_col else np.ones(n, dtype)
    return out


class ModelArraysMixin:
    """Save/load and get/set model data for models whose state is named
    arrays: metadata JSON + ``data/model_data.npz`` (``utils/read_write.py``),
    the same layout the JAX package writes."""

    _MODEL_ARRAY_NAMES: Tuple[str, ...] = ()

    def _model_arrays(self) -> Dict[str, np.ndarray]:
        missing = [n for n in self._MODEL_ARRAY_NAMES if getattr(self, n, None) is None]
        if missing:
            raise RuntimeError(
                f"{type(self).__name__} has no model data yet (missing {missing}); "
                "fit or set_model_data first"
            )
        return {n: np.asarray(getattr(self, n)) for n in self._MODEL_ARRAY_NAMES}

    def _set_model_arrays(self, arrays: Dict[str, np.ndarray]):
        for n in self._MODEL_ARRAY_NAMES:
            setattr(self, n, np.asarray(arrays[n]))
        return self

    def get_model_data(self):
        arrays = self._model_arrays()
        names = list(arrays)
        return [
            DataFrame(
                names,
                [DataTypes.vector(BasicType.DOUBLE)] * len(names),
                [[_to_row_value(arrays[n])] for n in names],
            )
        ]

    def set_model_data(self, *model_data: DataFrame):
        df = model_data[0]
        return self._set_model_arrays({n: _from_row_value(df.column(n)[0]) for n in self._MODEL_ARRAY_NAMES})

    def save(self, path: str) -> None:
        rw.save_metadata(self, path)
        rw.save_model_arrays(path, self._model_arrays())

    @classmethod
    def load(cls, path: str):
        """Load a directory saved by this class or by its JAX twin."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        model = cls()
        model.load_param_map_from_json(metadata["paramMap"])
        model._set_model_arrays(rw.load_model_arrays(path))
        return model


def _to_row_value(array: np.ndarray):
    return DenseVector(array) if array.ndim == 1 else array


def _from_row_value(value) -> np.ndarray:
    return value.to_array() if isinstance(value, Vector) else np.asarray(value)
