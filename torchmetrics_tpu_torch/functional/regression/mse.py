"""Mean squared error (counterpart of ``torchmetrics_tpu/functional/regression/mse.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _mean_squared_error_update(preds: torch.Tensor, target: torch.Tensor, num_outputs: int) -> Tuple[torch.Tensor, int]:
    """Sum of squared errors (per output) and the number of rows."""
    _check_same_shape(preds, target)
    if num_outputs == 1:
        preds = preds.reshape(-1)
        target = target.reshape(-1)
    diff = preds - target
    return (diff * diff).sum(dim=0), target.shape[0]


def _mean_squared_error_compute(
    sum_squared_error: torch.Tensor, n_obs: Union[int, torch.Tensor], squared: bool = True
) -> torch.Tensor:
    return sum_squared_error / n_obs if squared else torch.sqrt(sum_squared_error / n_obs)


def mean_squared_error(
    preds: torch.Tensor, target: torch.Tensor, squared: bool = True, num_outputs: int = 1
) -> torch.Tensor:
    """MSE (RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_error
        >>> float(mean_squared_error(torch.tensor([0.0, 1.0, 2.0, 3.0]), torch.tensor([0.0, 1.0, 2.0, 2.0])))
        0.25
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
