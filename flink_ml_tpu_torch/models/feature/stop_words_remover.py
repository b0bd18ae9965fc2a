"""StopWordsRemover — twin of ``flink_ml_tpu/models/feature/stop_words_remover.py``.

``StopWordsRemover.java``: a token-list filter over several columns.
``stopWords`` defaults to the English list (``loadDefaultStopWords``),
``caseSensitive`` to false (matching after a locale's lowercasing). The
Snowball lists, one file a language, are the port's own copy under
``stopwords/``. A host stage, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List

from flink_ml_tpu_torch.api.core import Transformer
from flink_ml_tpu_torch.api.types import DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.params.param import BoolParam, StringArrayParam, StringParam
from flink_ml_tpu_torch.params.shared import HasInputCols, HasOutputCols

__all__ = ["StopWordsRemover"]

_STOPWORDS_DIR = os.path.join(os.path.dirname(__file__), "stopwords")


def _available_languages() -> List[str]:
    return sorted(f[:-4] for f in os.listdir(_STOPWORDS_DIR) if f.endswith(".txt"))


def load_default_stop_words(language: str) -> List[str]:
    """StopWordsRemover.loadDefaultStopWords: the language's list."""
    path = os.path.join(_STOPWORDS_DIR, f"{language}.txt")
    if not os.path.exists(path):
        raise ValueError(
            f"{language} is not in the supported language list: {_available_languages()}."
        )
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def _locale_lower(locale: str):
    """The lowercasing of case-insensitive matching (``java.util.Locale`` in
    the reference): Turkish and Azerbaijani map the dotted and dotless i by
    their rules, every other locale uses ``str.lower``, as in the JAX
    package."""
    lang = locale.split("_")[0].lower()
    if lang in ("tr", "az"):
        def lower(s: str) -> str:
            return s.replace("İ", "i").replace("I", "ı").lower()

        return lower
    return str.lower


class StopWordsRemover(Transformer, HasInputCols, HasOutputCols):
    """StopWordsRemover.java."""

    STOP_WORDS = StringArrayParam(
        "stopWords", "The words to be filtered out.", load_default_stop_words("english")
    )
    CASE_SENSITIVE = BoolParam(
        "caseSensitive", "Whether to do a case-sensitive comparison over the stop words.", False
    )
    LOCALE = StringParam(
        "locale",
        "Locale of the input for case insensitive matching. Ignored when caseSensitive is true.",
        "en_US",
    )

    load_default_stop_words = staticmethod(load_default_stop_words)
    get_available_locales = staticmethod(_available_languages)

    def get_stop_words(self):
        return self.get(self.STOP_WORDS)

    def set_stop_words(self, *values: str):
        return self.set(self.STOP_WORDS, list(values))

    def get_case_sensitive(self) -> bool:
        return self.get(self.CASE_SENSITIVE)

    def set_case_sensitive(self, value: bool):
        return self.set(self.CASE_SENSITIVE, value)

    def get_locale(self) -> str:
        return self.get(self.LOCALE)

    def set_locale(self, value: str):
        return self.set(self.LOCALE, value)

    def transform(self, *inputs, device=None):
        """Each input column's token lists without the stop words, on the
        host; ``device`` (None → the GPU) is checked as every entry point
        checks it."""
        (df,) = inputs
        resolve_device(device)
        case_sensitive = self.get_case_sensitive()
        lower = _locale_lower(self.get_locale())
        stop = set(self.get_stop_words())
        if not case_sensitive:
            stop = {lower(w) for w in stop}

        def keep(token: str) -> bool:
            return (token if case_sensitive else lower(token)) not in stop

        out = df.clone()
        for in_name, out_name in zip(self.get_input_cols(), self.get_output_cols()):
            out.add_column(
                out_name, DataTypes.STRING,
                [[t for t in tokens if keep(t)] for tokens in df.column(in_name)],
            )
        return out
