"""Online serving: micro-batching, versioned hot swap, the compiled plan."""
from flink_ml_tpu_torch.serving.errors import (
    NoModelError,
    ServingClosedError,
    ServingDeadlineError,
    ServingError,
    ServingExecutionError,
    ServingOverloadedError,
)
from flink_ml_tpu_torch.serving.batcher import pad_to
from flink_ml_tpu_torch.serving.plan import CompiledServingPlan
from flink_ml_tpu_torch.serving.registry import ModelRegistry, ModelVersionPoller, publish_servable
from flink_ml_tpu_torch.serving.server import InferenceServer, ServingConfig, ServingResponse

__all__ = [
    "CompiledServingPlan",
    "InferenceServer",
    "ServingConfig",
    "ServingResponse",
    "ModelRegistry",
    "ModelVersionPoller",
    "publish_servable",
    "ServingError",
    "ServingOverloadedError",
    "ServingDeadlineError",
    "ServingClosedError",
    "ServingExecutionError",
    "NoModelError",
    "pad_to",
]
