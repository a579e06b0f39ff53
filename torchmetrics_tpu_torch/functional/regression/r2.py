"""R² score (counterpart of ``torchmetrics_tpu/functional/regression/r2.py``)."""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Σy², Σy, the residual sum of squares (per output) and the number of rows."""
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {preds.shape}"
        )
    sum_obs = target.sum(dim=0)
    sum_squared_obs = (target * target).sum(dim=0)
    residual = target - preds
    rss = (residual * residual).sum(dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    n_obs: Union[int, torch.Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """R² under the ``multioutput`` reduction, adjusted when ``adjusted`` > 0. Below two
    samples it raises (a host read of the count)."""
    if n_obs < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond = tss < 1e-4 * sum_squared_obs.abs()
    raw_scores = torch.where(cond, 0.0, 1 - (rss / torch.where(cond, 1.0, tss)))

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = raw_scores.mean()
    elif multioutput == "variance_weighted":
        r2 = (tss / tss.sum() * raw_scores).sum()
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
    if adjusted != 0:
        if adjusted > n_obs - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n_obs - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            return 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """R².

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import r2_score
        >>> round(float(r2_score(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4)
        0.9486
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
