"""Mean squared log error (counterpart of ``torchmetrics_tpu/functional/regression/log_mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Σ (log1p(pred) − log1p(target))² and the number of elements."""
    _check_same_shape(preds, target)
    return ((torch.log1p(preds) - torch.log1p(target)) ** 2).sum(), target.numel()


def _mean_squared_log_error_compute(
    sum_squared_log_error: torch.Tensor, n_obs: Union[int, torch.Tensor]
) -> torch.Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSLE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_log_error
        >>> round(float(mean_squared_log_error(torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0]))), 4)
        0.0286
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
