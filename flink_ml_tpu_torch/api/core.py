"""The core stage interfaces — twin of ``flink_ml_tpu/api/core.py``.

``Stage`` (params + save/load), ``AlgoOperator``/``Transformer``
(``transform``), ``Model`` (a Transformer with model data) and ``Estimator``
(``fit`` → Model), after flink-ml-core's ``Stage.java``, ``Estimator.java``,
``Transformer.java`` and ``Model.java``.
"""
from __future__ import annotations

from typing import List

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.params.param import WithParams
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["Stage", "Estimator", "AlgoOperator", "Transformer", "Model"]


class Stage(WithParams):
    """Base of all pipeline nodes; saved as metadata JSON (+ model data)."""

    def save(self, path: str) -> None:
        rw.save_metadata(self, path)

    @classmethod
    def load(cls, path: str) -> "Stage":
        """Restore a stage saved by this class or by its JAX twin
        (``utils.read_write.CLASS_TABLE``)."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        stage = cls()
        stage.load_param_map_from_json(metadata["paramMap"])
        return stage

    def __repr__(self) -> str:
        shown = {p.name: v for p, v in self._param_map.items() if v != p.default_value}
        return f"{type(self).__name__}({shown})"


class AlgoOperator(Stage):
    """Computes outputs from inputs."""

    def transform(self, *inputs: DataFrame):
        raise NotImplementedError


class Transformer(AlgoOperator):
    """An AlgoOperator whose semantics is record-wise transformation."""

    @classmethod
    def load_servable(cls, path: str) -> "Transformer":
        """A stateless Transformer is its own servable: its params describe
        ``transform`` whole, so loading it for serving loads the stage, as
        in the JAX package (``api/core.py``). A Model carries model data and
        must override this with its servable."""
        if issubclass(cls, Model):
            raise RuntimeError(f"{cls.__name__}.load_servable(path) is not implemented.")
        return cls.load(path)


class Model(Transformer):
    """A Transformer with model data."""

    def set_model_data(self, *model_data: DataFrame) -> "Model":
        raise NotImplementedError

    def get_model_data(self) -> List[DataFrame]:
        raise NotImplementedError


class Estimator(Stage):
    """Trains a Model from data."""

    def fit(self, *inputs: DataFrame) -> Model:
        raise NotImplementedError
