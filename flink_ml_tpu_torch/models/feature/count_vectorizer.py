"""CountVectorizer — twin of ``flink_ml_tpu/models/feature/count_vectorizer.py``.

``CountVectorizer.java``: fit learns a vocabulary from token lists — the
document frequency of each term filtered by ``minDF`` / ``maxDF`` (a count
when ≥ 1, else a share of the documents), the kept terms ordered by count,
descending, then by the term, and cut to ``vocabularySize``. The model turns
documents into term-count sparse vectors: ``minTF`` drops a term under a
count (≥ 1) or under a share of the document's token count (< 1), and
``binary`` maps every count to 1. The vocabulary lookup runs on the host;
the counting and the minTF filter are the device ``sparse_combine_fn`` and
``sparse_threshold_fn`` on both the per-stage path and the fused spec.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from flink_ml_tpu_torch.api.core import Estimator, Model
from flink_ml_tpu_torch.api.dataframe import DataFrame
from flink_ml_tpu_torch.api.types import BasicType, DataTypes
from flink_ml_tpu_torch.device import resolve_device
from flink_ml_tpu_torch.ops.kernels import sparse_combine_fn, sparse_threshold_fn
from flink_ml_tpu_torch.params.param import (
    BoolParam,
    FloatParam,
    IntParam,
    ParamValidators,
    update_existing_params,
)
from flink_ml_tpu_torch.params.shared import HasInputCol, HasOutputCol
from flink_ml_tpu_torch.servable.kernel_spec import KernelSpec
from flink_ml_tpu_torch.servable.lib import entry_tensors
from flink_ml_tpu_torch.servable.sparse import (
    entries_names,
    pack_entry_rows,
    rebuild_sparse_column,
    sparse_names,
)
from flink_ml_tpu_torch.utils import read_write as rw

__all__ = ["CountVectorizer", "CountVectorizerModel"]


class _CvParams(HasInputCol, HasOutputCol):
    VOCABULARY_SIZE = IntParam(
        "vocabularySize", "Max size of the vocabulary.", 1 << 18, ParamValidators.gt(0)
    )
    MIN_DF = FloatParam(
        "minDF",
        "Minimum number (>=1) or fraction (<1) of documents a term must appear in.",
        1.0,
        ParamValidators.gt_eq(0),
    )
    MAX_DF = FloatParam(
        "maxDF",
        "Maximum number (>=1) or fraction (<1) of documents a term may appear in.",
        float(2**63 - 1),
        ParamValidators.gt_eq(0),
    )
    MIN_TF = FloatParam(
        "minTF",
        "Minimum count (>=1) or fraction of the document's token count (<1) to include a term.",
        1.0,
        ParamValidators.gt_eq(0),
    )
    BINARY = BoolParam("binary", "Binary toggle for the output counts.", False)

    def get_vocabulary_size(self) -> int:
        return self.get(self.VOCABULARY_SIZE)

    def set_vocabulary_size(self, value: int):
        return self.set(self.VOCABULARY_SIZE, value)

    def get_min_df(self) -> float:
        return self.get(self.MIN_DF)

    def set_min_df(self, value: float):
        return self.set(self.MIN_DF, value)

    def get_max_df(self) -> float:
        return self.get(self.MAX_DF)

    def set_max_df(self, value: float):
        return self.set(self.MAX_DF, value)

    def get_min_tf(self) -> float:
        return self.get(self.MIN_TF)

    def set_min_tf(self, value: float):
        return self.set(self.MIN_TF, value)

    def get_binary(self) -> bool:
        return self.get(self.BINARY)

    def set_binary(self, value: bool):
        return self.set(self.BINARY, value)


def _count_fn(values, ids, nnz, lengths, min_tf: float, binary: bool):
    """The device half of the transform: raw entries combined into counts,
    the minTF filter, then ``binary``. A fractional minTF's bar is the
    float32 product of minTF rounded to float32 and the document's raw token
    count — the rounding of the JAX package, whose weakly typed Python float
    times an int32 length computes in float32."""
    values, ids, nnz = sparse_combine_fn(values, ids, nnz)
    bar = torch.tensor(min_tf, dtype=torch.float32, device=values.device)
    threshold = bar.expand(nnz.shape) if min_tf >= 1.0 else bar * lengths.to(torch.float32)
    values, ids, nnz = sparse_threshold_fn(values, ids, nnz, threshold)
    if binary:
        values = torch.clamp(values, max=1.0)
    return values, ids, nnz


class CountVectorizerModel(Model, _CvParams):
    """CountVectorizerModel.java — vocabulary-indexed term counts. The
    fitted model is its own servable, as in the JAX package."""

    def __init__(self):
        super().__init__()
        self.vocabulary: Optional[List[str]] = None

    def _featurize(self, col):
        """The host half: each token looked up in the vocabulary,
        out-of-vocabulary tokens dropped, duplicates kept for the device
        combine; each row's raw token count beside. Shared by ``transform``
        and the spec's host ingest."""
        vocab = {term: i for i, term in enumerate(self.vocabulary)}
        rows = []
        lengths = []
        for tokens in col:
            rows.append([(vocab[t], 1.0) for t in tokens if t in vocab])
            lengths.append(len(tokens))
        return rows, lengths

    def transform(self, *inputs, device=None):
        """Term counts on ``device`` (None → the GPU), through the body the
        fused spec runs (``_count_fn``)."""
        (df,) = inputs
        dev = resolve_device(device)
        out_col = self.get_output_col()
        rows, lengths = self._featurize(df.column(self.get_input_col()))
        values, ids, nnz, lens = entry_tensors(out_col, rows, lengths, dev)
        values, ids, nnz = _count_fn(values, ids, nnz, lens, float(self.get_min_tf()), self.get_binary())
        vectors = rebuild_sparse_column(
            len(self.vocabulary), values.cpu().numpy(), ids.cpu().numpy(), nnz.cpu().numpy()
        )
        out = df.clone()
        out.add_column(out_col, DataTypes.vector(BasicType.DOUBLE), vectors)
        return out

    def sparse_kernel_spec(self, known):
        """The spec of the sparse convention: the vocabulary lookup at the
        host ingest, ``_count_fn`` on the device (the fractional minTF's bar
        from the raw length the quadruple carries), the output sparse."""
        if self.vocabulary is None:
            raise RuntimeError("set_model_data must be called before kernel_spec")
        binary = self.get_binary()
        min_tf = float(self.get_min_tf())
        in_col, out_col = self.get_input_col(), self.get_output_col()
        vn, idn, zn, ln = entries_names(in_col)
        out_v, out_i, out_z = sparse_names(out_col)

        def host_ingest(df, cap, cap_max, truncate):
            rows, lengths = self._featurize(df.column(in_col))
            return pack_entry_rows(in_col, rows, lengths, cap=cap, cap_max=cap_max, truncate=truncate)

        def kernel_fn(model, cols):
            values, ids, nnz = _count_fn(cols[vn], cols[idn], cols[zn], cols[ln], min_tf, binary)
            return {out_v: values, out_i: ids, out_z: nnz}

        return KernelSpec(
            input_cols=(in_col,),
            outputs=((out_col, DataTypes.vector(BasicType.DOUBLE)),),
            model_arrays={},
            kernel_fn=kernel_fn,
            input_kinds={in_col: "entries"},
            host_ingests={in_col: host_ingest},
            sparse_outputs={out_col: len(self.vocabulary)},
        )

    # model data: the ordered vocabulary
    def get_model_data(self):
        return [DataFrame(["vocabulary"], None, [[list(self.vocabulary)]])]

    def set_model_data(self, *model_data: DataFrame):
        self.vocabulary = list(model_data[0].column("vocabulary")[0])
        return self

    def save(self, path: str) -> None:
        """Metadata and the vocabulary as an npz string array, the JAX
        package's layout."""
        rw.save_metadata(self, path)
        rw.save_model_arrays(path, {"vocabulary": np.asarray(self.vocabulary, dtype=str)})

    @classmethod
    def load(cls, path: str):
        """Load a directory saved by this class or by its JAX twin."""
        metadata = rw.load_metadata(path, rw.stage_class_name(cls))
        model = cls()
        model.load_param_map_from_json(metadata["paramMap"])
        model.vocabulary = [str(s) for s in rw.load_model_arrays(path)["vocabulary"]]
        return model

    @classmethod
    def load_servable(cls, path: str) -> "CountVectorizerModel":
        return cls.load(path)


class CountVectorizer(Estimator, _CvParams):
    """CountVectorizer.java: the vocabulary counted on the host."""

    def fit(self, *inputs) -> CountVectorizerModel:
        (df,) = inputs
        col = df.column(self.get_input_col())
        num_docs = len(col)
        doc_freq = {}
        term_count = {}
        for tokens in col:
            for t in set(tokens):
                doc_freq[t] = doc_freq.get(t, 0) + 1
            for t in tokens:
                term_count[t] = term_count.get(t, 0) + 1
        min_df = self.get_min_df()
        max_df = self.get_max_df()
        lo = min_df if min_df >= 1.0 else min_df * num_docs
        hi = max_df if max_df >= 1.0 else max_df * num_docs
        if lo > hi:
            raise ValueError("maxDF must be >= minDF")
        kept = [t for t, dfreq in doc_freq.items() if lo <= dfreq <= hi]
        kept.sort(key=lambda t: (-term_count[t], t))
        vocab = kept[: self.get_vocabulary_size()]
        if not vocab:
            raise RuntimeError("The vocabulary is empty; check minDF/maxDF settings.")
        model = CountVectorizerModel()
        update_existing_params(model, self)
        model.vocabulary = vocab
        return model
