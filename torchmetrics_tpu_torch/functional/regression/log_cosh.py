"""Log-cosh error (counterpart of ``torchmetrics_tpu/functional/regression/log_cosh.py``)."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _unsqueeze_tensors(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.ndim == 2:
        return preds, target
    return preds[:, None], target[:, None]


def _log_cosh_error_update(
    preds: torch.Tensor, target: torch.Tensor, num_outputs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ log(cosh(error)) per output (squeezed) and the int32 number of rows."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    preds, target = _unsqueeze_tensors(preds, target)
    diff = preds - target
    # log(cosh(x)) = x + softplus(-2x) - log(2), softplus as jax.nn.softplus: logaddexp(x, 0)
    softplus = torch.logaddexp(-2 * diff, torch.zeros_like(diff))
    sum_log_cosh_error = (diff + softplus - math.log(2.0)).sum(dim=0).squeeze()
    return sum_log_cosh_error, torch.full((), preds.shape[0], dtype=torch.int32, device=preds.device)


def _log_cosh_error_compute(sum_log_cosh_error: torch.Tensor, n_obs: torch.Tensor) -> torch.Tensor:
    return (sum_log_cosh_error / n_obs).squeeze()


def log_cosh_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Log-cosh error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import log_cosh_error
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(log_cosh_error(preds, target)), 4)
        0.1685
    """
    sum_log_cosh_error, n_obs = _log_cosh_error_update(
        preds, target, num_outputs=1 if preds.ndim == 1 else preds.shape[-1]
    )
    return _log_cosh_error_compute(sum_log_cosh_error, n_obs)
