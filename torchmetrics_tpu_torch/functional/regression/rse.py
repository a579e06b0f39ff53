"""Relative squared error (counterpart of ``torchmetrics_tpu/functional/regression/rse.py``)."""

from __future__ import annotations

from typing import Union

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import _r2_score_update


def _relative_squared_error_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    sum_squared_error: torch.Tensor,
    n_obs: Union[int, torch.Tensor],
    squared: bool = True,
) -> torch.Tensor:
    """RSE = Σ(y − ŷ)² / Σ(y − ȳ)², averaged over the outputs."""
    epsilon = torch.finfo(torch.float32).eps
    rse = sum_squared_error / torch.clamp(sum_squared_obs - sum_obs * sum_obs / n_obs, min=epsilon)
    if not squared:
        rse = torch.sqrt(rse)
    return rse.mean()


def relative_squared_error(preds: torch.Tensor, target: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """RSE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_squared_error
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(relative_squared_error(preds, target)), 4)
        0.0514
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _relative_squared_error_compute(sum_squared_obs, sum_obs, rss, n_obs, squared=squared)
