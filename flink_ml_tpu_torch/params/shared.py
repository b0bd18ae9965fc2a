"""Shared ``HasXxx`` param mixins — the ones the ported servables and the
linear estimators declare.

Twin of ``flink_ml_tpu/params/shared.py``: same param names, defaults and
validators, so a stage saved by the JAX package restores its params here.
Each mixin declares one Param as a class attribute plus typed accessors.
"""
from __future__ import annotations

from flink_ml_tpu_torch.params.param import (
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
    WithParams,
)

__all__ = [
    "HasDistanceMeasure",
    "HasElasticNet",
    "HasFeaturesCol",
    "HasGlobalBatchSize",
    "HasLabelCol",
    "HasLearningRate",
    "HasMaxIter",
    "HasMultiClass",
    "HasReg",
    "HasSeed",
    "HasTol",
    "HasWeightCol",
    "HasPredictionCol",
    "HasRawPredictionCol",
    "HasInputCol",
    "HasK",
    "HasOutputCol",
]


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam("featuresCol", "Features column name.", "features", ParamValidators.not_null())

    def get_features_col(self) -> str:
        return self.get(self.FEATURES_COL)

    def set_features_col(self, value: str):
        return self.set(self.FEATURES_COL, value)


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam("predictionCol", "Prediction column name.", "prediction", ParamValidators.not_null())

    def get_prediction_col(self) -> str:
        return self.get(self.PREDICTION_COL)

    def set_prediction_col(self, value: str):
        return self.set(self.PREDICTION_COL, value)


class HasRawPredictionCol(WithParams):
    RAW_PREDICTION_COL = StringParam("rawPredictionCol", "Raw prediction column name.", "rawPrediction")

    def get_raw_prediction_col(self) -> str:
        return self.get(self.RAW_PREDICTION_COL)

    def set_raw_prediction_col(self, value: str):
        return self.set(self.RAW_PREDICTION_COL, value)


class HasInputCol(WithParams):
    INPUT_COL = StringParam("inputCol", "Input column name.", "input", ParamValidators.not_null())

    def get_input_col(self) -> str:
        return self.get(self.INPUT_COL)

    def set_input_col(self, value: str):
        return self.set(self.INPUT_COL, value)


class HasOutputCol(WithParams):
    OUTPUT_COL = StringParam("outputCol", "Output column name.", "output", ParamValidators.not_null())

    def get_output_col(self) -> str:
        return self.get(self.OUTPUT_COL)

    def set_output_col(self, value: str):
        return self.set(self.OUTPUT_COL, value)


class HasLabelCol(WithParams):
    LABEL_COL = StringParam("labelCol", "Label column name.", "label", ParamValidators.not_null())

    def get_label_col(self) -> str:
        return self.get(self.LABEL_COL)

    def set_label_col(self, value: str):
        return self.set(self.LABEL_COL, value)


class HasWeightCol(WithParams):
    WEIGHT_COL = StringParam("weightCol", "Weight column name.", None)

    def get_weight_col(self) -> str:
        return self.get(self.WEIGHT_COL)

    def set_weight_col(self, value: str):
        return self.set(self.WEIGHT_COL, value)


class HasMaxIter(WithParams):
    MAX_ITER = IntParam("maxIter", "Maximum number of iterations.", 20, ParamValidators.gt(0))

    def get_max_iter(self) -> int:
        return self.get(self.MAX_ITER)

    def set_max_iter(self, value: int):
        return self.set(self.MAX_ITER, value)


class HasTol(WithParams):
    TOL = FloatParam("tol", "Convergence tolerance for iterative algorithms.", 1e-6, ParamValidators.gt_eq(0))

    def get_tol(self) -> float:
        return self.get(self.TOL)

    def set_tol(self, value: float):
        return self.set(self.TOL, value)


class HasLearningRate(WithParams):
    LEARNING_RATE = FloatParam("learningRate", "Learning rate of optimization method.", 0.1, ParamValidators.gt(0))

    def get_learning_rate(self) -> float:
        return self.get(self.LEARNING_RATE)

    def set_learning_rate(self, value: float):
        return self.set(self.LEARNING_RATE, value)


class HasGlobalBatchSize(WithParams):
    GLOBAL_BATCH_SIZE = IntParam("globalBatchSize", "Global batch size of training algorithms.", 32, ParamValidators.gt(0))

    def get_global_batch_size(self) -> int:
        return self.get(self.GLOBAL_BATCH_SIZE)

    def set_global_batch_size(self, value: int):
        return self.set(self.GLOBAL_BATCH_SIZE, value)


class HasReg(WithParams):
    REG = FloatParam("reg", "Regularization parameter.", 0.0, ParamValidators.gt_eq(0))

    def get_reg(self) -> float:
        return self.get(self.REG)

    def set_reg(self, value: float):
        return self.set(self.REG, value)


class HasElasticNet(WithParams):
    ELASTIC_NET = FloatParam(
        "elasticNet", "ElasticNet parameter (0 = L2, 1 = L1).", 0.0, ParamValidators.in_range(0.0, 1.0)
    )

    def get_elastic_net(self) -> float:
        return self.get(self.ELASTIC_NET)

    def set_elastic_net(self, value: float):
        return self.set(self.ELASTIC_NET, value)


class HasSeed(WithParams):
    SEED = IntParam("seed", "The random seed.", None)

    def get_seed(self) -> int:
        v = self.get(self.SEED)
        return 0 if v is None else v

    def set_seed(self, value: int):
        return self.set(self.SEED, value)


class HasDistanceMeasure(WithParams):
    DISTANCE_MEASURE = StringParam(
        "distanceMeasure",
        "Distance measure. Supported: euclidean, manhattan, cosine.",
        "euclidean",
        ParamValidators.in_array(["euclidean", "manhattan", "cosine"]),
    )

    def get_distance_measure(self) -> str:
        return self.get(self.DISTANCE_MEASURE)

    def set_distance_measure(self, value: str):
        return self.set(self.DISTANCE_MEASURE, value)


class HasK(WithParams):
    """The number of clusters, default 2. Lives here (not
    ``models/clustering/kmeans.py``) so the runtime-free KMeansModelServable
    can declare it without importing the training stack."""

    K = IntParam("k", "The max number of clusters to create.", 2, ParamValidators.gt(1))

    def get_k(self) -> int:
        return self.get(self.K)

    def set_k(self, value: int):
        return self.set(self.K, value)


class HasMultiClass(WithParams):
    MULTI_CLASS = StringParam(
        "multiClass",
        "Classification type.",
        "auto",
        ParamValidators.in_array(["auto", "binomial", "multinomial"]),
    )

    def get_multi_class(self) -> str:
        return self.get(self.MULTI_CLASS)

    def set_multi_class(self, value: str):
        return self.set(self.MULTI_CLASS, value)
