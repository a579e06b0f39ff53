"""Relative global dimensionless synthesis error (counterpart of ``torchmetrics_tpu/functional/image/ergas.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helper import _check_image_shape
from torchmetrics_tpu_torch.utilities.distributed import reduce


def _ergas_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check BxCxHxW inputs of one dtype."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    return _check_image_shape(preds, target)


def _ergas_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Per-image ERGAS, reduced."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 * ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: torch.Tensor,
    target: torch.Tensor,
    ratio: Union[int, float] = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Relative global dimensionless synthesis error (ERGAS).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import error_relative_global_dimensionless_synthesis
        >>> preds = torch.full((1, 2, 4, 4), 0.5)
        >>> round(float(error_relative_global_dimensionless_synthesis(preds, preds * 0.75 + 0.25)), 4)
        80.0
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
