"""Mean absolute error (counterpart of ``torchmetrics_tpu/functional/regression/mae.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _float32_unless_floating(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Sum of absolute errors and the number of elements; integer inputs in float32."""
    _check_same_shape(preds, target)
    preds, target = _float32_unless_floating(preds), _float32_unless_floating(target)
    return (preds - target).abs().sum(), target.numel()


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, n_obs: Union[int, torch.Tensor]) -> torch.Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MAE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_error
        >>> float(mean_absolute_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])))
        0.5
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
