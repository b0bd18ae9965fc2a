"""Termination criteria — twin of ``flink_ml_tpu/iteration/termination.py``.

Reference: ``TerminateOnMaxIter.java:34`` and ``TerminateOnMaxIterOrTol.java:34``.
Each is a callable that produces the ``termination_criteria`` of an
``IterationBodyResult``: truthy continues the iteration.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

__all__ = ["TerminateOnMaxIter", "TerminateOnMaxIterOrTol"]


class TerminateOnMaxIter:
    """Continue while ``epoch + 1 < max_iter``."""

    def __init__(self, max_iter: int):
        self.max_iter = max_iter

    def __call__(self, epoch: int, loss: Any = None) -> bool:
        return epoch + 1 < self.max_iter


class TerminateOnMaxIterOrTol:
    """Continue while the epoch budget remains and ``loss >= tol``.

    A ``loss`` given as a tensor is read once, and only when ``tol`` is
    finite, so a run without a tolerance never waits for the device.
    """

    def __init__(self, max_iter: Optional[int] = None, tol: Optional[float] = None):
        self.max_iter = math.inf if max_iter is None else max_iter
        self.tol = -math.inf if tol is None else tol

    def __call__(self, epoch: int, loss: Any = None) -> bool:
        if epoch + 1 >= self.max_iter:
            return False
        if loss is not None and self.tol > -math.inf:
            if isinstance(loss, torch.Tensor):
                loss = float(loss)
            if loss < self.tol:
                return False
        return True
