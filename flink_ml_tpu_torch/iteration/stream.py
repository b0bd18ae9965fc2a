"""Mini-batch streams — the part of ``flink_ml_tpu/iteration/stream.py`` that
the streamed fits use: ``rebatch`` and its helpers (JAX :40-108, :204).

Reference: ``DataStreamUtils.generateBatchData:734`` (online minibatching:
collect ``globalBatchSize`` records, then emit one batch). A batch is a dict
of equally long host columns; ``KMeans.fit_stream`` re-chunks a cache's
chunks into fixed-size device chunks with ``rebatch``, and
``HostDataCache.iter_minibatches`` is ``rebatch`` over the chunk log.
``window_stream``, ``batch_stream_from_dataframe`` and the ``Windows``
descriptors come with the online trainers (ROADMAP.md, queue A 8).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List

import numpy as np

__all__ = ["Batch", "rebatch"]

Batch = Dict[str, np.ndarray]


def _batch_len(batch: Batch) -> int:
    return next(iter(batch.values())).shape[0]


def _slice(batch: Batch, lo: int, hi: int) -> Batch:
    return {k: v[lo:hi] for k, v in batch.items()}


def _concat(chunks: List[Batch]) -> Batch:
    keys = chunks[0].keys()
    return {k: np.concatenate([c[k] for c in chunks]) for k in keys}


def rebatch(stream: Iterable[Batch], batch_size: int, drop_last: bool = False) -> Iterator[Batch]:
    """Re-chunk any batch stream into batches of ``batch_size`` rows:
    accumulate until a full batch is there, then emit exactly one; the
    trailing partial batch is emitted unless ``drop_last``."""
    pending: List[Batch] = []
    pending_rows = 0
    for batch in stream:
        pending.append(batch)
        pending_rows += _batch_len(batch)
        while pending_rows >= batch_size:
            taken: Dict[str, List[np.ndarray]] = {}
            need = batch_size
            rest: List[Batch] = []
            for chunk in pending:
                n = _batch_len(chunk)
                if need == 0:
                    rest.append(chunk)
                    continue
                use = min(need, n)
                for k, v in chunk.items():
                    taken.setdefault(k, []).append(v[:use])
                if use < n:
                    rest.append(_slice(chunk, use, n))
                need -= use
            pending = rest
            pending_rows -= batch_size
            yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}
    if pending_rows and not drop_last:
        taken = {}
        for chunk in pending:
            for k, v in chunk.items():
                taken.setdefault(k, []).append(v)
        yield {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in taken.items()}
