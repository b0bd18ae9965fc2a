"""The training-data cache — twin of ``flink_ml_tpu/iteration/datacache.py``'s
``DeviceDataCache``.

The dataset is placed on the device **once** and every epoch reads the same
buffers: zero host↔device traffic after load. Without a mesh the cache holds
every row on one device (``local_rows == n_valid``). On a
:class:`~flink_ml_tpu_torch.parallel.mesh.MeshContext` of N ranks, as the JAX
cache shards over its mesh's data axis, every rank is handed the whole input
and uploads only its contiguous share: the rows are zero-padded to a multiple
of N, rank k holds ``[k·m, (k+1)·m)`` with ``m = ceil(n / N)``, and the mask
is 0 on the padding; the ranks of one data index (the model shards of a
tensor-parallel mesh) hold the same rows. A column named in
``column_specs`` with the model axis on its second dimension (JAX
``P(data, model)``) is column-sliced as well: its width zero-padded to a
multiple of ``n_model`` and the rank's slice uploaded, so dense tensor
parallelism never holds the whole matrix on a rank. The streamed capacity tier (``HostDataCache``) is not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from flink_ml_tpu_torch.device import resolve_device

__all__ = ["DeviceDataCache"]


def _model_axis_spec(spec) -> bool:
    """Whether a JAX-style spec tuple names the model axis on dimension 1."""
    return spec is not None and len(spec) > 1 and spec[1] == "model"


class DeviceDataCache:
    """Columnar dataset resident on ``device`` (``None`` → the GPU), or this
    rank's share of it on ``ctx``'s device.

    ``columns`` maps name → host array [n, ...] (every rank passes the whole
    input). The sparse columns (``indices``/``values``) are also kept on the
    host whole, zero-copy, because the one-hot layout is built from them
    there over every rank's rows. ``mask`` is 1.0 on real rows and 0.0 on
    the mesh's padding. The trainer memoises its one-hot layout
    (``_onehot_memo``) and materialised row one-hots (``_onehot_premat_memo``)
    on the cache, so they live as long as the data.
    """

    def __init__(self, columns: Dict[str, np.ndarray],
                 device: Optional[Union[str, torch.device]] = None, ctx=None,
                 column_specs: Optional[Dict[str, tuple]] = None):
        self.ctx = ctx
        self.device = ctx.device if ctx is not None else resolve_device(device)
        lengths = {np.asarray(c).shape[0] for c in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        n_data = ctx.n_data if ctx is not None else 1
        lo, hi, m = ctx.local_range(n) if ctx is not None else (0, n, n)
        self.n_valid = n
        self.n_padded = m * n_data
        self.host_columns: Dict[str, np.ndarray] = {}
        self.arrays: Dict[str, torch.Tensor] = {}
        self.model_sharded = set()
        for name, col in columns.items():
            col = np.asarray(col)
            if name in ("indices", "values"):
                self.host_columns[name] = col
            local = col[lo:hi]
            if _model_axis_spec((column_specs or {}).get(name)) and ctx is not None:
                c0, c1, d_pad = ctx.model_range(col.shape[1])
                if d_pad > col.shape[1]:  # zero columns: zero margins, zero gradients
                    local = np.concatenate([local, np.zeros((local.shape[0], d_pad - col.shape[1]), col.dtype)], 1)
                local = local[:, c0:c1]
                self.model_sharded.add(name)
            if hi - lo < m:  # the rank holding the padding
                local = np.concatenate([local, np.zeros((m - (hi - lo),) + col.shape[1:], col.dtype)])
            self.arrays[name] = torch.from_numpy(np.ascontiguousarray(local)).to(self.device)
        mask = torch.zeros(m, dtype=torch.float32)
        mask[: hi - lo] = 1.0
        self.arrays["__mask__"] = mask.to(self.device)
        self._onehot_memo = None
        self._onehot_premat_memo = None

    @property
    def n_data(self) -> int:
        return self.ctx.n_data if self.ctx is not None else 1

    @property
    def local_rows(self) -> int:
        """Rows on this device (padded on a mesh)."""
        return self.n_padded // self.n_data

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    @property
    def mask(self) -> torch.Tensor:
        return self.arrays["__mask__"]
