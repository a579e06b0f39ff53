"""Mean absolute percentage error (counterpart of ``torchmetrics_tpu/functional/regression/mape.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    """Σ |error| / max(|target|, epsilon) and the number of elements."""
    _check_same_shape(preds, target)
    abs_per_error = (preds - target).abs() / torch.clamp(target.abs(), min=epsilon)
    return abs_per_error.sum(), target.numel()


def _mean_absolute_percentage_error_compute(
    sum_abs_per_error: torch.Tensor, num_obs: Union[int, torch.Tensor]
) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MAPE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> round(float(mean_absolute_percentage_error(torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0]))), 4)
        0.3274
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
