"""NGram — twin of ``flink_ml_tpu/models/feature/ngram.py``.

``NGram.java``: each token list becomes its n-grams joined by spaces; a
list shorter than n gives an empty one. A host stage, as in the JAX package.
"""
from __future__ import annotations

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol

__all__ = ["NGram"]


class NGram(Transformer, HasInputCol, HasOutputCol):
    """NGram.java."""

    N = IntParam("n", "Number of elements per n-gram (>=1).", 2, ParamValidators.gt_eq(1))

    def get_n(self) -> int:
        return self.get(self.N)

    def set_n(self, value: int):
        return self.set(self.N, value)

    def transform(self, *inputs, device=None):
        """The n-grams of each token list, on the host; ``device`` (None →
        the GPU) is checked as every entry point checks it."""
        (df,) = inputs
        resolve_device(device)
        n = self.get_n()
        grams = [
            [" ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]
            for tokens in df.column(self.get_input_col())
        ]
        out = df.clone()
        out.add_column(self.get_output_col(), DataTypes.STRING, grams)
        return out
