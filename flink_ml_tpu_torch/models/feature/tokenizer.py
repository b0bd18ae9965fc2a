"""Tokenizer and RegexTokenizer — twin of
``flink_ml_tpu/models/feature/tokenizer.py``.

``Tokenizer.java``: lowercase, then split on ``\\s``. ``RegexTokenizer.java``:
``pattern`` (default ``\\s+``) matches the gaps when ``gaps`` (default true)
and the tokens otherwise; tokens shorter than ``minTokenLength`` (default 1)
are dropped; ``toLowercase`` defaults to true. Both are host stages: strings
never reach the device, and a pipeline runs them as per-stage segments, as
in the JAX package.
"""
from __future__ import annotations

import re

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.params.param import BoolParam, IntParam, ParamValidators, StringParam
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol

__all__ = ["Tokenizer", "RegexTokenizer"]


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    """Tokenizer.java — lowercase then ``split("\\s")``: consecutive
    whitespace leaves interior empty tokens (Java's split drops only the
    trailing ones), which HashingTF and CountVectorizer see as terms."""

    def transform(self, *inputs, device=None):
        """Token lists of the input strings; ``device`` (None → the GPU) is
        checked as every entry point checks it, and no tensor is made."""
        (df,) = inputs
        resolve_device(device)
        tokens = []
        for s in df.column(self.get_input_col()):
            toks = re.split(r"\s", s.lower())
            while toks and toks[-1] == "":
                toks.pop()
            tokens.append(toks)
        out = df.clone()
        out.add_column(self.get_output_col(), DataTypes.STRING, tokens)
        return out


class RegexTokenizer(Transformer, HasInputCol, HasOutputCol):
    """RegexTokenizer.java."""

    PATTERN = StringParam("pattern", "Regex pattern used for tokenizing.", r"\s+")
    GAPS = BoolParam(
        "gaps", "Whether the pattern matches gaps (true) or tokens (false).", True
    )
    MIN_TOKEN_LENGTH = IntParam(
        "minTokenLength", "Minimum token length.", 1, ParamValidators.gt_eq(0)
    )
    TO_LOWERCASE = BoolParam(
        "toLowercase", "Whether to convert all characters to lowercase before tokenizing.", True
    )

    def get_pattern(self) -> str:
        return self.get(self.PATTERN)

    def set_pattern(self, value: str):
        return self.set(self.PATTERN, value)

    def get_gaps(self) -> bool:
        return self.get(self.GAPS)

    def set_gaps(self, value: bool):
        return self.set(self.GAPS, value)

    def get_min_token_length(self) -> int:
        return self.get(self.MIN_TOKEN_LENGTH)

    def set_min_token_length(self, value: int):
        return self.set(self.MIN_TOKEN_LENGTH, value)

    def get_to_lowercase(self) -> bool:
        return self.get(self.TO_LOWERCASE)

    def set_to_lowercase(self, value: bool):
        return self.set(self.TO_LOWERCASE, value)

    def transform(self, *inputs, device=None):
        """Token lists of the input strings, on the host (``device`` as in
        :meth:`Tokenizer.transform`)."""
        (df,) = inputs
        resolve_device(device)
        pattern = re.compile(self.get_pattern())
        gaps = self.get_gaps()
        min_len = self.get_min_token_length()
        lower = self.get_to_lowercase()
        tokens = []
        for s in df.column(self.get_input_col()):
            if lower:
                s = s.lower()
            toks = pattern.split(s) if gaps else pattern.findall(s)
            tokens.append([t for t in toks if len(t) >= min_len])
        out = df.clone()
        out.add_column(self.get_output_col(), DataTypes.STRING, tokens)
        return out
