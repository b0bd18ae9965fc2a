"""Pipeline / PipelineModel — twin of ``flink_ml_tpu/builder/pipeline.py``.

After flink-ml-core's ``Pipeline.java`` and ``PipelineModel.java``:

- ``Pipeline.fit`` trains the stages in order: each Estimator is fitted on
  the current table and replaced by its Model, and the table becomes that
  stage's transform output. Stages at or after the last Estimator are not
  transformed (``Pipeline.java:88-98``): their outputs would be discarded.
- ``PipelineModel.transform`` chains the stages' transforms; with
  ``batch.fastpath`` on, a single-input chain whose stages expose kernel
  specs runs through :class:`~flink_ml_tpu_torch.builder.batch_plan.CompiledBatchPlan`.
- ``save`` / ``load`` write each stage to ``<path>/stages/%08d`` beside a
  pipeline metadata file with ``numStages``, the layout both packages read.

Entry points take ``device`` (None → the GPU) and hand it to every stage.
"""
from __future__ import annotations

import inspect
import json
import os
from typing import Any, List, Optional, Sequence, Tuple

from flink_ml_tpu_torch.api.core import AlgoOperator, Estimator, Model, Stage
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.config import Options, config
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["Pipeline", "PipelineModel"]

_STAGES_DIR = "stages"


def _save_stages(stages: Sequence[Stage], path: str) -> None:
    for i, stage in enumerate(stages):
        stage.save(os.path.join(path, _STAGES_DIR, f"{i:08d}"))


def _load_stages(path: str) -> List[Stage]:
    stages_dir = os.path.join(path, _STAGES_DIR)
    return [rw.load_stage(os.path.join(stages_dir, name)) for name in sorted(os.listdir(stages_dir))]


def _with_device(fn, inputs: Sequence[DataFrame], device):
    """``fn(*inputs, device=device)`` when ``fn`` takes a device (every port
    stage that computes does; IDF and Imputer fit on the host)."""
    if "device" in inspect.signature(fn).parameters:
        return fn(*inputs, device=device)
    return fn(*inputs)


def _as_list(out) -> List[DataFrame]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


class Pipeline(Estimator):
    """An Estimator composed of a sequence of stages (Pipeline.java)."""

    def __init__(self, stages: Sequence[Stage] = ()):
        super().__init__()
        self.stages: List[Stage] = list(stages)

    def fit(self, *inputs: DataFrame, device=None) -> "PipelineModel":
        """Fit the stages in order on ``device`` (None → the GPU), feeding
        each stage the previous one's output; stages at or after the last
        Estimator are kept as they are and not transformed."""
        device = resolve_device(device)
        last_estimator = max((i for i, s in enumerate(self.stages) if isinstance(s, Estimator)),
                             default=-1)
        last_inputs = list(inputs)
        model_stages: List[Stage] = []
        for i, stage in enumerate(self.stages):
            fitted = _with_device(stage.fit, last_inputs, device) if isinstance(stage, Estimator) else stage
            model_stages.append(fitted)
            if i < last_estimator and isinstance(fitted, AlgoOperator):
                last_inputs = _as_list(_with_device(fitted.transform, last_inputs, device))
        return PipelineModel(model_stages)

    def save(self, path: str) -> None:
        rw.save_metadata(self, path, {"numStages": len(self.stages)})
        _save_stages(self.stages, path)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        """Load a Pipeline saved by either package."""
        rw.load_metadata(path, rw.stage_class_name(cls))
        return cls(_load_stages(path))


class PipelineModel(Model):
    """A Model chaining the transforms of its stages (PipelineModel.java)."""

    def __init__(self, stages: Sequence[Stage] = ()):
        super().__init__()
        self.stages: List[Stage] = list(stages)
        #: (fingerprint, plan or None) — see :meth:`_batch_plan`.
        self._plan_cache: Optional[Tuple[Tuple, Any]] = None

    def transform(self, *inputs: DataFrame, device=None):
        """The stages' transforms in order, on ``device`` (None → the GPU).

        With ``batch.fastpath`` on (the default), a single input whose stages
        expose kernel specs runs through the batch plan — chained device
        programs over chunked, prefetched ingest, bit-exact with the
        per-stage path in the exact tier. A plan that meets a stage with
        several outputs gives way to the per-stage path."""
        device = resolve_device(device)
        if len(inputs) == 1 and config.get(Options.BATCH_FASTPATH):
            from flink_ml_tpu_torch.builder.batch_plan import BatchPlanInapplicable

            plan = self._batch_plan(inputs[0], device)
            if plan is not None:
                try:
                    return plan.transform(inputs[0])
                except BatchPlanInapplicable:
                    pass  # a multi-output stage mid-chain: the per-stage path below
        last_inputs = list(inputs)
        for stage in self.stages:
            last_inputs = _as_list(_with_device(stage.transform, last_inputs, device))
        return last_inputs[0] if len(last_inputs) == 1 else last_inputs

    def _fingerprint(self, sparse_hints, device) -> Tuple:
        """Cheap identity of the chain a plan snapshots: the device its model
        tensors live on and the ``batch.mesh`` × ``batch.mesh.model`` shard
        grid they sit on (a mesh change rebuilds), the fusion-tier config its
        programs were partitioned under (a ``fusion.mode`` flip rebuilds
        rather than keep the old tier's numerics), the sparse hints its segments were specialised
        for, and each stage's identity and param map. Model data is covered
        by ``set_model_data`` dropping the plan; changing a stage's arrays in
        place needs :meth:`invalidate_batch_plan`."""
        fusion_key = (
            config.get(Options.FUSION_MODE),
            config.get(Options.FUSION_MEGAKERNEL),
            config.get(Options.FUSION_MEGAKERNEL_MIN_SCORE),
        )
        sparse_key = None if sparse_hints is None else tuple(sorted(sparse_hints.items()))
        mesh_key = (config.get(Options.BATCH_MESH), config.get(Options.BATCH_MESH_MODEL))
        return (str(device), mesh_key, fusion_key, sparse_key) + tuple(
            (id(stage), json.dumps(stage.param_map_to_json(), sort_keys=True, default=str))
            for stage in self.stages
        )

    def _batch_plan(self, df: Optional[DataFrame], device):
        from flink_ml_tpu_torch.builder.batch_plan import CompiledBatchPlan
        from flink_ml_tpu_torch.servable.sparse import resolve_sparse_hints

        sparse_hints = resolve_sparse_hints(df)
        fp = self._fingerprint(sparse_hints, device)
        if self._plan_cache is None or self._plan_cache[0] != fp:
            self._plan_cache = (
                fp, CompiledBatchPlan.build(self.stages, device=device, sparse=sparse_hints)
            )
        return self._plan_cache[1]

    def invalidate_batch_plan(self) -> "PipelineModel":
        """Drop the cached batch plan (after changing a stage's model arrays
        in place; ``set_model_data`` does this itself)."""
        self._plan_cache = None
        return self

    def set_model_data(self, *model_data: DataFrame) -> "PipelineModel":
        self.invalidate_batch_plan()
        i = 0
        for stage in self.stages:
            if isinstance(stage, Model):
                n = len(stage.get_model_data())
                stage.set_model_data(*model_data[i: i + n])
                i += n
        return self

    def get_model_data(self) -> List[DataFrame]:
        out: List[DataFrame] = []
        for stage in self.stages:
            if isinstance(stage, Model):
                out.extend(stage.get_model_data())
        return out

    def save(self, path: str) -> None:
        rw.save_metadata(self, path, {"numStages": len(self.stages)})
        _save_stages(self.stages, path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        """Load a PipelineModel saved by either package, each stage as the
        port stage its class name resolves to."""
        rw.load_metadata(path, rw.stage_class_name(cls))
        return cls(_load_stages(path))

    @classmethod
    def load_servable(cls, path: str):
        """The runtime-free servable of a saved PipelineModel: each stage
        through its own ``load_servable``, so kernel-spec stages fuse on the
        serving fast path."""
        from flink_ml_tpu_torch.servable.builder import PipelineModelServable

        return PipelineModelServable.load(path)
