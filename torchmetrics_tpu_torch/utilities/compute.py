"""Safe math helpers and trapezoidal AUC (counterpart of ``torchmetrics_tpu/utilities/compute.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The sigmoid every binary and multilabel path applies to logits.

    Float32 is computed in float64 and rounded once, so a logit's probability does not
    depend on the tensor it sits in: ``torch.sigmoid`` on the CPU gives float32 results
    that change with the batch shape, and the card's differs from the CPU's. Half and
    bfloat16 take ``1 / (1 + exp(-x))`` in their own dtype, operation by operation, as
    ``jax.nn.sigmoid`` computes them in the JAX package. Float64 stays as it is.
    """
    if x.dtype == torch.float32:
        return torch.sigmoid(x.to(torch.float64)).to(torch.float32)
    if x.dtype in (torch.float16, torch.bfloat16):
        return 1 / (1 + torch.exp(-x))
    return torch.sigmoid(x)


def _safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x * log(y)`` with ``0 * log(0) = 0``."""
    y_safe = torch.where(x == 0, torch.ones_like(y), y)
    return torch.where(x == 0, torch.zeros_like(x * torch.log(y_safe)), x * torch.log(y_safe))


def _safe_divide(num: torch.Tensor, denom: torch.Tensor, zero_division: float = 0.0) -> torch.Tensor:
    """Division with ``x/0 -> zero_division``; integer inputs divide in float32."""
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom if denom.is_floating_point() else denom.to(torch.float32)
    denom_safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    quotient = num / denom_safe
    return torch.where(denom == 0, torch.full_like(quotient, zero_division), quotient)


def _sum_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x.sum(axis)`` that is a no-op on 0-d tensors."""
    return x.sum(dim=axis) if x.ndim else x


def _adjust_weights_safe_divide(
    score: torch.Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
) -> torch.Tensor:
    """Weighted or macro reduction of per-class scores."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(score.dtype)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            weights = torch.where(tp + fp + fn == 0, torch.zeros_like(weights), weights)
    # reduce over the class axis only: samplewise inputs are (N, C) and keep their N
    return _safe_divide(weights * score, weights.sum(dim=-1, keepdim=True)).sum(dim=-1)


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float, axis: int = -1) -> torch.Tensor:
    """Trapezoidal area assuming monotone ``x``."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y_avg = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0
    return (y_avg * dx).sum(dim=axis) * direction
