"""Stage composition: Pipeline, PipelineModel and the batch plan — twin of
``flink_ml_tpu/builder`` (the graph builder is still to be ported)."""

from flink_ml_tpu_torch.builder.batch_plan import CompiledBatchPlan
from flink_ml_tpu_torch.builder.pipeline import Pipeline, PipelineModel

__all__ = ["CompiledBatchPlan", "Pipeline", "PipelineModel"]
