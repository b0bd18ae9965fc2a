"""The training-data cache on one device — twin of
``flink_ml_tpu/iteration/datacache.py``'s ``DeviceDataCache``.

The dataset is placed on the device **once** and every epoch reads the same
buffers: zero host↔device traffic after load. The JAX cache shards over a
mesh's data axis; the port trains on one device, so ``n_data = 1`` and no
row padding is ever added (``local_rows == n_valid``). The streamed capacity
tier (``HostDataCache``) is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from flink_ml_tpu_torch.device import resolve_device

__all__ = ["DeviceDataCache"]


class DeviceDataCache:
    """Columnar dataset resident on ``device`` (``None`` → the GPU).

    ``columns`` maps name → host array [n, ...]. The sparse columns
    (``indices``/``values``) are also kept on the host, zero-copy, because
    the one-hot layout is built from them there. ``mask`` is 1.0 for every
    row (there is no shard padding on one device). The trainer memoises its
    one-hot layout (``_onehot_memo``) and materialised row one-hots
    (``_onehot_premat_memo``) on the cache, so they live as long as the data.
    """

    def __init__(self, columns: Dict[str, np.ndarray],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        lengths = {np.asarray(c).shape[0] for c in columns.values()}
        if len(lengths) != 1:
            raise ValueError(f"inconsistent column lengths {lengths}")
        (n,) = lengths
        self.n_valid = n
        self.n_padded = n
        self.host_columns: Dict[str, np.ndarray] = {}
        self.arrays: Dict[str, torch.Tensor] = {}
        for name, col in columns.items():
            col = np.asarray(col)
            if name in ("indices", "values"):
                self.host_columns[name] = col
            self.arrays[name] = torch.from_numpy(np.ascontiguousarray(col)).to(self.device)
        self.arrays["__mask__"] = torch.ones(n, dtype=torch.float32, device=self.device)
        self._onehot_memo = None
        self._onehot_premat_memo = None

    @property
    def local_rows(self) -> int:
        """Rows on the device (all of them: one device, no padding)."""
        return self.n_padded

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.arrays[name]

    @property
    def mask(self) -> torch.Tensor:
        return self.arrays["__mask__"]
