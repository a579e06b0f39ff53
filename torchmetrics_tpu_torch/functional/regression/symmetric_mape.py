"""Symmetric MAPE (counterpart of ``torchmetrics_tpu/functional/regression/symmetric_mape.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _symmetric_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    """Σ 2 |error| / max(|target| + |pred|, epsilon) and the number of elements."""
    _check_same_shape(preds, target)
    arr = torch.clamp(target.abs() + preds.abs(), min=epsilon)
    return (2 * (preds - target).abs() / arr).sum(), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(
    sum_abs_per_error: torch.Tensor, num_obs: Union[int, torch.Tensor]
) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SMAPE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.2455
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
