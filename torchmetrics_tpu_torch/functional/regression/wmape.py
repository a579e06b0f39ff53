"""Weighted MAPE (counterpart of ``torchmetrics_tpu/functional/regression/wmape.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _weighted_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ |error| and Σ |target|."""
    _check_same_shape(preds, target)
    return (preds - target).flatten().abs().sum(), target.flatten().abs().sum()


def _weighted_mean_absolute_percentage_error_compute(
    sum_abs_error: torch.Tensor, sum_scale: torch.Tensor, epsilon: float = 1.17e-06
) -> torch.Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """WMAPE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.16
    """
    sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
    return _weighted_mean_absolute_percentage_error_compute(sum_abs_error, sum_scale)
