"""Relative average spectral error (counterpart of ``torchmetrics_tpu/functional/image/rase.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helper import _uniform_filter
from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update


def _rase_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    window_size: int,
    rmse_map: Optional[torch.Tensor],
    target_sum: Optional[torch.Tensor],
    total_images: Optional[Union[int, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor, Union[int, torch.Tensor]]:
    """Add one batch to the windowed RMSE map and the windowed target sum."""
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    this_target_sum = torch.sum(_uniform_filter(target, window_size) / (window_size**2), dim=0)
    target_sum = (target_sum if target_sum is not None else 0.0) + this_target_sum
    return rmse_map, target_sum, total_images


def _rase_compute(
    rmse_map: torch.Tensor, target_sum: torch.Tensor, total_images: Union[int, torch.Tensor], window_size: int
) -> torch.Tensor:
    """RASE from the accumulated maps."""
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = target_sum / total_images
    target_mean = target_mean.mean(0)  # over the channels
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop_slide = round(window_size / 2)
    return torch.mean(rase_map[crop_slide:-crop_slide, crop_slide:-crop_slide])


def relative_average_spectral_error(preds: torch.Tensor, target: torch.Tensor, window_size: int = 8) -> torch.Tensor:
    """Relative average spectral error (RASE).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_average_spectral_error
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> float(relative_average_spectral_error(preds, preds * 0.75 + 0.1)) > 0
        True
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_map, target_sum, total_images = _rase_update(
        preds, target, window_size, rmse_map=None, target_sum=None, total_images=None
    )
    return _rase_compute(rmse_map, target_sum, total_images, window_size)
