"""PipelineModelServable — chain servables loaded from a saved PipelineModel.

Twin of ``flink_ml_tpu/servable/builder.py``.
"""
from __future__ import annotations

import os
from typing import List, Sequence

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.servable.api import TransformerServable, load_servable
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["PipelineModelServable"]


class PipelineModelServable(TransformerServable):
    """Sequentially applies its servables."""

    def __init__(self, servables: Sequence[TransformerServable] = ()):
        super().__init__()
        self.servables: List[TransformerServable] = list(servables)

    def transform(self, df: DataFrame, device=None) -> DataFrame:
        device = resolve_device(device)
        for servable in self.servables:
            df = servable.transform(df, device=device)
        return df

    def set_model_data(self, *model_data_inputs) -> "PipelineModelServable":
        """One stream to each stage that holds model data, in order."""
        i = 0
        for servable in self.servables:
            if getattr(servable, "_MODEL_ARRAY_NAMES", ()):
                servable.set_model_data(model_data_inputs[i])
                i += 1
        return self

    @staticmethod
    def load(path: str) -> "PipelineModelServable":
        """Load from a directory written by either package's
        ``PipelineModel.save`` (``numStages`` in the metadata, stage
        subdirectories ``stages/%08d``, each loaded through
        :func:`load_servable`)."""
        metadata = rw.load_metadata(path)
        num_stages = metadata["numStages"]
        stages_dir = os.path.join(path, "stages")
        servables = [
            load_servable(os.path.join(stages_dir, f"{i:08d}")) for i in range(num_stages)
        ]
        return PipelineModelServable(servables)

    @classmethod
    def load_servable(cls, path: str) -> "PipelineModelServable":
        return cls.load(path)
