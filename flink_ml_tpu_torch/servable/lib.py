"""Concrete servables — twin of ``flink_ml_tpu/servable/lib.py`` for the
StandardScaler → LogisticRegression serving path, dense and sparse, the
StandardScaler → MLPClassifier path and the StandardScaler → KMeans path.

Each servable's per-stage ``transform`` and its ``kernel_spec().kernel_fn``
(or ``sparse_kernel_spec``) compose the same ``ops/kernels.py`` functions, so
the per-stage path, the planner's programs and the megakernels' plain
versions run the same math.
"""
from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops.kernels import (
    dot_fn,
    kmeans_assign_fn,
    logistic_from_dots_fn,
    mlp_predict_fn,
    scale_fn,
    sparse_dot_fn,
)
from flink_ml_tpu_torch.params.param import BoolParam
from flink_ml_tpu_torch.params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasInputCol,
    HasK,
    HasOutputCol,
    HasPredictionCol,
    HasRawPredictionCol,
)
from flink_ml_tpu_torch.servable.api import ModelServable
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.sparse import pack_sparse_column, sparse_names

__all__ = [
    "KMeansModelServable",
    "LogisticRegressionModelServable",
    "MLPClassifierModelServable",
    "StandardScalerModelServable",
    "logistic_predict",
    "packed_tensors",
]


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Read a float32 result back, widened (value-exactly) to float64."""
    return t.cpu().numpy().astype(np.float64)


def packed_tensors(df: DataFrame, col: str, dim: int, device: torch.device):
    """A SparseVector column as the convention's ``(values, ids, nnz)``
    tensors on ``device``, packed at its natural ladder cap — never as a
    dense [n, dim] array."""
    arrays, _cap, _dim, _nnz = pack_sparse_column(df, col, dim=dim)
    return tuple(torch.from_numpy(arrays[name]).to(device) for name in sparse_names(col))


def logistic_predict(df: DataFrame, features_col: str, coefficient, device: torch.device):
    """``(prediction, rawPrediction)`` float32 tensors for ``df``'s features:
    a sparse column through ``sparse_dot_fn`` on its packed triple (whose
    sequential fold makes the margin the same at every nnz cap), a dense
    one through ``dot_fn``. Shared by the servable and the training-side
    model."""
    coef = _to_device(coefficient, device)
    if df.is_sparse(features_col):
        values, ids, _nnz = packed_tensors(df, features_col, int(coef.shape[0]), device)
        dots = sparse_dot_fn(values, ids, coef)
    else:
        dots = dot_fn(_to_device(df.vectors(features_col), device), coef)
    return logistic_from_dots_fn(dots)


class LogisticRegressionModelServable(
    ModelServable, HasFeaturesCol, HasPredictionCol, HasRawPredictionCol
):
    """prediction = margin ≥ 0, rawPrediction = [1−p, p], p = sigmoid(margin),
    for dense or SparseVector features (a sparse column stays packed)."""

    _MODEL_ARRAY_NAMES = ("coefficient",)

    def __init__(self):
        super().__init__()
        self.coefficient = None

    def transform(self, df: DataFrame, device=None) -> DataFrame:
        if self.coefficient is None:
            raise RuntimeError("set_model_data must be called before transform")
        pred, raw = logistic_predict(
            df, self.get_features_col(), self.coefficient, resolve_device(device)
        )
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, _to_host(pred))
        out.add_column(
            self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE), _to_host(raw)
        )
        return out

    def kernel_spec(self) -> KernelSpec:
        """Margin dot + logistic head, the same math as ``transform``."""
        if self.coefficient is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        features_col = self.get_features_col()
        pred_col, raw_col = self.get_prediction_col(), self.get_raw_prediction_col()

        def kernel_fn(model, cols):
            pred, raw = logistic_from_dots_fn(dot_fn(cols[features_col], model["coefficient"]))
            return {pred_col: pred, raw_col: raw}

        return KernelSpec(
            input_cols=(features_col,),
            outputs=(
                (pred_col, DataTypes.DOUBLE),
                (raw_col, DataTypes.vector(BasicType.DOUBLE)),
            ),
            model_arrays={"coefficient": np.asarray(self.coefficient, np.float32)},
            kernel_fn=kernel_fn,
            fusion_op="logistic",
        )

    def sparse_kernel_spec(self, known):
        """The sparse-convention head: when the features column is known
        sparse at the coefficient's width, the margin is ``sparse_dot_fn``
        on the packed triple — the body ``transform``'s sparse path runs —
        feeding the shared logistic head. Otherwise None (the dense spec
        serves)."""
        if self.coefficient is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        features_col = self.get_features_col()
        pred_col, raw_col = self.get_prediction_col(), self.get_raw_prediction_col()
        dim = int(np.asarray(self.coefficient).shape[0])
        if known.get(features_col) != dim:
            return None
        in_v, in_i, _in_z = sparse_names(features_col)

        def kernel_fn(model, cols):
            pred, raw = logistic_from_dots_fn(
                sparse_dot_fn(cols[in_v], cols[in_i], model["coefficient"])
            )
            return {pred_col: pred, raw_col: raw}

        return KernelSpec(
            input_cols=(features_col,),
            outputs=(
                (pred_col, DataTypes.DOUBLE),
                (raw_col, DataTypes.vector(BasicType.DOUBLE)),
            ),
            model_arrays={"coefficient": np.asarray(self.coefficient, np.float32)},
            kernel_fn=kernel_fn,
            input_kinds={features_col: "sparse"},
            sparse_input_dims={features_col: dim},
            fusion_op="sparse_logistic",
        )


def kmeans_predict(X: np.ndarray, centroids, measure: str, device: torch.device) -> torch.Tensor:
    """The closest centroid's index [n] (int64) of each row of ``X`` under
    ``measure``, float32 on ``device``. Shared by the servable and the
    training-side model."""
    return kmeans_assign_fn(measure)(_to_device(X, device), _to_device(centroids, device))


class KMeansModelServable(
    ModelServable, HasFeaturesCol, HasPredictionCol, HasDistanceMeasure, HasK
):
    """prediction = the index of the closest centroid, as DOUBLE. Model
    data: ``centroids [k, d]`` and ``weights [k]`` (the cluster sizes)."""

    _MODEL_ARRAY_NAMES = ("centroids", "weights")

    def __init__(self):
        super().__init__()
        self.centroids = None  # [k, d]
        self.weights = None  # [k]

    def transform(self, df: DataFrame, device=None) -> DataFrame:
        if self.centroids is None:
            raise RuntimeError("set_model_data must be called before transform")
        pred = kmeans_predict(
            df.vectors(self.get_features_col()), self.centroids,
            self.get_distance_measure(), resolve_device(device),
        )
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, _to_host(pred))
        return out

    def kernel_spec(self) -> KernelSpec:
        """Closest-centroid assignment as a fusable spec — ``transform``'s
        ``kmeans_assign_fn`` body, the centroids device-resident. The
        measure rides in ``fusion_params`` for the CUDA megakernel."""
        if self.centroids is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        features_col, pred_col = self.get_features_col(), self.get_prediction_col()
        measure = self.get_distance_measure()
        assign = kmeans_assign_fn(measure)

        def kernel_fn(model, cols):
            return {pred_col: assign(cols[features_col], model["centroids"])}

        return KernelSpec(
            input_cols=(features_col,),
            outputs=((pred_col, DataTypes.DOUBLE),),
            model_arrays={"centroids": np.asarray(self.centroids, np.float32)},
            kernel_fn=kernel_fn,
            fusion_op="kmeans",
            fusion_params={"distance_measure": measure},
        )


class MLPClassifierModelServable(
    ModelServable, HasFeaturesCol, HasPredictionCol, HasRawPredictionCol
):
    """The MLP's forward pass and softmax head through ``mlp_predict_fn``,
    float32. Model data: ``W0``/``b0`` … ``W{L-1}``/``b{L-1}`` layer pairs and
    the ``labels`` class-value table (prediction = ``labels[argmax]``). Class
    values are small integers, exact in float32, so the device-side gather
    of the kernel spec and the host-side gather of ``transform`` agree."""

    def __init__(self):
        super().__init__()
        self.layers = None  # [(W [d_in, d_out], b [d_out]), ...] float32
        self.labels = None  # [classes] class values

    def _apply_model_arrays(self, arrays) -> "MLPClassifierModelServable":
        layers = []
        while f"W{len(layers)}" in arrays:
            i = len(layers)
            layers.append((np.asarray(arrays[f"W{i}"], np.float32), np.asarray(arrays[f"b{i}"], np.float32)))
        if not layers:
            raise ValueError(
                f"MLP model data must carry at least one W0/b0 layer pair; got arrays {sorted(arrays)}"
            )
        self.layers = layers
        self.labels = np.asarray(arrays["labels"])
        return self

    def transform(self, df: DataFrame, device=None) -> DataFrame:
        if self.layers is None:
            raise RuntimeError("set_model_data must be called before transform")
        device = resolve_device(device)
        layers = [(_to_device(W, device), _to_device(b, device)) for W, b in self.layers]
        pred_idx, probs = mlp_predict_fn(layers, _to_device(df.vectors(self.get_features_col()), device))
        pred = np.asarray(self.labels)[pred_idx.cpu().numpy().astype(np.int64)]
        out = df.clone()
        out.add_column(self.get_prediction_col(), DataTypes.DOUBLE, np.asarray(pred, np.float64))
        out.add_column(
            self.get_raw_prediction_col(), DataTypes.vector(BasicType.DOUBLE), _to_host(probs)
        )
        return out

    def kernel_spec(self) -> KernelSpec:
        """The forward pass and head as a fusable spec — ``transform``'s
        ``mlp_predict_fn`` body, with the label gather on the device."""
        if self.layers is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        features_col = self.get_features_col()
        pred_col, probs_col = self.get_prediction_col(), self.get_raw_prediction_col()
        n_layers = len(self.layers)
        model_arrays = {"labels": np.asarray(self.labels, np.float32)}
        for i, (W, b) in enumerate(self.layers):
            model_arrays[f"W{i}"] = W
            model_arrays[f"b{i}"] = b

        def kernel_fn(model, cols):
            layers = [(model[f"W{i}"], model[f"b{i}"]) for i in range(n_layers)]
            pred_idx, probs = mlp_predict_fn(layers, cols[features_col])
            return {pred_col: model["labels"][pred_idx.long()], probs_col: probs}

        return KernelSpec(
            input_cols=(features_col,),
            outputs=(
                (pred_col, DataTypes.DOUBLE),
                (probs_col, DataTypes.vector(BasicType.DOUBLE)),
            ),
            model_arrays=model_arrays,
            kernel_fn=kernel_fn,
            fusion_op="mlp",
        )


class StandardScalerModelServable(ModelServable, HasInputCol, HasOutputCol):
    """Standardization with a saved mean and std."""

    # Param names match the training-side StandardScalerModel, so its saved
    # metadata restores them directly.
    WITH_MEAN = BoolParam("withMean", "Whether centers the data with mean before scaling.", False)
    WITH_STD = BoolParam("withStd", "Whether scales the data with standard deviation.", True)

    _MODEL_ARRAY_NAMES = ("mean", "std")

    def __init__(self):
        super().__init__()
        self.mean = None
        self.std = None

    def get_with_mean(self) -> bool:
        return self.get(self.WITH_MEAN)

    def set_with_mean(self, value: bool):
        return self.set(self.WITH_MEAN, value)

    def get_with_std(self) -> bool:
        return self.get(self.WITH_STD)

    def set_with_std(self, value: bool):
        return self.set(self.WITH_STD, value)

    def _inv_std(self) -> np.ndarray:
        """0-std features scale to 0 (the reference's guard), never divide.
        Computed on the host in float32 exactly as the JAX package does — the
        bits of the scaled column depend on it."""
        std = np.asarray(self.std, np.float32)
        return np.where(std == 0.0, 0.0, 1.0 / np.where(std == 0.0, 1.0, std))

    def transform(self, df: DataFrame, device=None) -> DataFrame:
        if self.mean is None:
            raise RuntimeError("set_model_data must be called before transform")
        device = resolve_device(device)
        out_vals = scale_fn(
            _to_device(df.vectors(self.get_input_col()), device),
            _to_device(self.mean, device),
            _to_device(self._inv_std(), device),
            with_mean=self.get_with_mean(),
            with_std=self.get_with_std(),
        )
        out = df.clone()
        out.add_column(
            self.get_output_col(), DataTypes.vector(BasicType.DOUBLE), _to_host(out_vals)
        )
        return out

    def kernel_spec(self) -> KernelSpec:
        """Standardization as a fusable spec; mean and the precomputed
        inverse std become device-resident model tensors."""
        if self.mean is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        input_col, output_col = self.get_input_col(), self.get_output_col()
        with_mean, with_std = self.get_with_mean(), self.get_with_std()

        def kernel_fn(model, cols):
            return {
                output_col: scale_fn(
                    cols[input_col], model["mean"], model["inv_std"],
                    with_mean=with_mean, with_std=with_std,
                )
            }

        return KernelSpec(
            input_cols=(input_col,),
            outputs=((output_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={
                "mean": np.asarray(self.mean, np.float32),
                "inv_std": self._inv_std(),
            },
            kernel_fn=kernel_fn,
            elementwise=True,  # shift + scale: no accumulation
            fusion_op="scale",
            fusion_params={"with_mean": with_mean, "with_std": with_std},
        )
