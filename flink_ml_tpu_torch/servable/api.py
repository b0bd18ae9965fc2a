"""Servable interfaces — twin of ``flink_ml_tpu/servable/api.py``.

``transform(df, device=None)`` is the per-stage path: DataFrame in, DataFrame
out, computed on ``device`` (``None`` → the GPU, see ``device.py``).
``kernel_spec()`` optionally describes the same math as a
:class:`~flink_ml_tpu_torch.servable.kernel_spec.KernelSpec` so the serving
plan can chain it with its neighbours. Model data comes from the
``data/model_data.npz`` a saved stage carries, from npz byte streams
(``ModelServable.set_model_data``), or from arrays in memory
(``servable/convert.py``).
"""
from __future__ import annotations

import io
from typing import BinaryIO, Dict

import numpy as np

from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.params.param import WithParams
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = [
    "TransformerServable",
    "ModelServable",
    "ModelDataConflictError",
    "load_servable",
]


class ModelDataConflictError(ValueError):
    """Two model-data streams carry the same array name: ``set_model_data``
    refuses to let the later stream win, which would serve from half of
    each."""

    def __init__(self, key: str, stream_index: int):
        self.key = key
        self.stream_index = stream_index
        super().__init__(
            f"model data stream {stream_index} redefines array {key!r} already "
            "provided by an earlier stream"
        )


class TransformerServable(WithParams):
    def transform(self, df: DataFrame, device=None) -> DataFrame:
        raise NotImplementedError

    def kernel_spec(self):
        """Optional pure-kernel description of ``transform`` for the serving
        fast path; None keeps the stage on the per-stage ``transform``."""
        return None

    @classmethod
    def load_servable(cls, path: str) -> "TransformerServable":
        """Restore the params this servable declares from a saved stage,
        ignoring training-only params in its metadata."""
        metadata = rw.load_metadata(path)
        servable = cls()
        servable.load_known_params(metadata["paramMap"])
        return servable

    def load_known_params(self, param_map: Dict[str, object]) -> "TransformerServable":
        """Set every JSON-encoded param this servable declares; skip the rest."""
        known = {p.name for p in self.get_param_map()}
        self.load_param_map_from_json({k: v for k, v in param_map.items() if k in known})
        return self


class ModelServable(TransformerServable):
    """A TransformerServable with model data."""

    _MODEL_ARRAY_NAMES = ()

    def set_model_data(self, *model_data_inputs: BinaryIO) -> "ModelServable":
        """Read model arrays from npz byte streams (``ModelServable.java:32``'s
        varargs ``setModelData``), merged by name; a name in two streams
        raises ``ModelDataConflictError``."""
        if not model_data_inputs:
            raise ValueError("expected at least 1 model data stream, got 0")
        arrays: Dict[str, np.ndarray] = {}
        for i, stream in enumerate(model_data_inputs):
            with np.load(io.BytesIO(stream.read())) as z:
                for k in z.files:
                    if k in arrays:
                        raise ModelDataConflictError(k, i)
                    arrays[k] = z[k]
        return self._apply_model_arrays(arrays)

    def _apply_model_arrays(self, arrays: Dict[str, np.ndarray]) -> "ModelServable":
        for name in self._MODEL_ARRAY_NAMES:
            setattr(self, name, np.asarray(arrays[name]))
        return self

    @classmethod
    def load_servable(cls, path: str) -> "ModelServable":
        servable = super().load_servable(path)
        servable._apply_model_arrays(rw.load_model_arrays(path))
        return servable


def load_servable(path: str) -> TransformerServable:
    """Load a saved stage directory — written by either package — as a port
    servable: the saved ``className`` resolves through
    ``utils.read_write.CLASS_TABLE`` to the port class whose
    ``load_servable(path)`` reads it."""
    metadata = rw.load_metadata(path)
    cls = rw.resolve_class(metadata["className"])
    return cls.load_servable(path)
