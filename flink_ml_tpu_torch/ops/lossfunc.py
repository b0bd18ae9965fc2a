"""Loss functions, batched — twin of ``flink_ml_tpu/ops/lossfunc.py``.

Reference: ``flink-ml-lib/.../common/lossfunc/`` (``BinaryLogisticLoss``,
``HingeLoss``, ``LeastSquareLoss``). Labels are {0, 1} for the two
classifiers (scaled to ``ys = 2·label − 1``), real for least squares; every
row carries a weight. ``loss_and_grad_sum`` returns *sums*, so the trainer
divides by the batch's total weight exactly as the reference does.

The port has no autograd default: every loss is analytic. A custom loss
subclasses :class:`LossFunc` and overrides ``row_loss_and_mult`` (and with
it ``loss_and_mult`` and ``loss_and_grad_sum``).
"""
from __future__ import annotations

import torch

__all__ = ["LossFunc", "BinaryLogisticLoss", "HingeLoss", "LeastSquareLoss"]


class LossFunc:
    """Batched loss over margins ``dot`` [n], labels ``y`` [n], weights ``w`` [n]."""

    def row_loss_and_mult(self, dot, y, w):
        """(per-row weighted loss [n], per-row ∂loss/∂dot [n])."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement row_loss_and_mult; the "
            "port has no autograd default, every loss is analytic"
        )

    def loss_and_mult(self, dot, y, w):
        """(Σ loss, per-row ∂loss/∂dot) from the margins ``dot = X @ coef`` —
        the primitive both feature layouts share (dense ``X.T @ mult``,
        sparse scatter of ``values * mult``)."""
        row_loss, mult = self.row_loss_and_mult(dot, y, w)
        return torch.sum(row_loss), mult

    def loss_and_grad_sum(self, coef, X, y, w):
        """(Σ loss, Σ ∂loss/∂coef) for dense ``X`` [n, d]."""
        loss, mult = self.loss_and_mult(X @ coef, y, w)
        return loss, X.T @ mult


def _softplus(x):
    # log(1 + exp(x)) without the threshold torch's softplus applies
    return torch.logaddexp(x, torch.zeros_like(x))


class BinaryLogisticLoss(LossFunc):
    """loss = w·log(1 + exp(−dot·ys)); multiplier = w·(−ys·sigmoid(−dot·ys))."""

    INSTANCE = None  # populated below

    def row_loss_and_mult(self, dot, y, w):
        ys = 2.0 * y - 1.0
        z = dot * ys
        return w * _softplus(-z), w * (-ys * torch.sigmoid(-z))


class HingeLoss(LossFunc):
    """loss = w·max(0, 1 − ys·dot); subgradient −ys·w inside the margin."""

    INSTANCE = None

    def row_loss_and_mult(self, dot, y, w):
        ys = 2.0 * y - 1.0
        margin = 1.0 - ys * dot
        return (
            w * torch.clamp(margin, min=0.0),
            torch.where(margin > 0.0, -ys * w, torch.zeros_like(w)),
        )


class LeastSquareLoss(LossFunc):
    """loss = w·½(dot − y)²; multiplier = w·(dot − y)."""

    INSTANCE = None

    def row_loss_and_mult(self, dot, y, w):
        err = dot - y
        return w * 0.5 * err * err, w * err


BinaryLogisticLoss.INSTANCE = BinaryLogisticLoss()
HingeLoss.INSTANCE = HingeLoss()
LeastSquareLoss.INSTANCE = LeastSquareLoss()
