"""Runtime-free servables and the compiled-plan machinery behind the serving
fast path."""
from flink_ml_tpu_torch.servable.api import ModelServable, TransformerServable, load_servable
from flink_ml_tpu_torch.servable.builder import PipelineModelServable
from flink_ml_tpu_torch.servable.convert import servable_from_arrays
from flink_ml_tpu_torch.servable.lib import (
    KMeansModelServable,
    LogisticRegressionModelServable,
    MLPClassifierModelServable,
    StandardScalerModelServable,
)

__all__ = [
    "TransformerServable",
    "ModelServable",
    "load_servable",
    "servable_from_arrays",
    "PipelineModelServable",
    "KMeansModelServable",
    "LogisticRegressionModelServable",
    "MLPClassifierModelServable",
    "StandardScalerModelServable",
]
