"""RMSE over a sliding window (counterpart of ``torchmetrics_tpu/functional/image/rmse_sw.py``).

``window_size=1`` crops ``[0:-0]``, an empty map, so the value is NaN, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helper import _check_image_shape, _uniform_filter


def _rmse_sw_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    window_size: int,
    rmse_val_sum: Optional[torch.Tensor],
    rmse_map: Optional[torch.Tensor],
    total_images: Optional[Union[int, torch.Tensor]],
) -> Tuple[torch.Tensor, torch.Tensor, Union[int, torch.Tensor]]:
    """Add one batch to the windowed RMSE sums: the per-image mean, the map, the count."""
    if preds.dtype != target.dtype:
        raise TypeError(
            f"Expected `preds` and `target` to have the same data type. But got {preds.dtype} and {target.dtype}."
        )
    _check_image_shape(preds, target)
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )

    total_images = (total_images if total_images is not None else 0) + target.shape[0]
    error = (target - preds) ** 2
    error = _uniform_filter(error, window_size)
    _rmse_map = torch.sqrt(error)
    crop_slide = round(window_size / 2)

    rmse_val = _rmse_map[:, :, crop_slide:-crop_slide, crop_slide:-crop_slide].sum(0).mean()
    rmse_val_sum = (rmse_val_sum if rmse_val_sum is not None else 0.0) + rmse_val
    rmse_map = (rmse_map if rmse_map is not None else 0.0) + _rmse_map.sum(0)
    return rmse_val_sum, rmse_map, total_images


def _rmse_sw_compute(
    rmse_val_sum: Optional[torch.Tensor], rmse_map: Optional[torch.Tensor], total_images: Union[int, torch.Tensor]
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Divide the accumulated sums by the image count."""
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    rmse_map = rmse_map / total_images if rmse_map is not None else None
    return rmse, rmse_map


def root_mean_squared_error_using_sliding_window(
    preds: torch.Tensor, target: torch.Tensor, window_size: int = 8, return_rmse_map: bool = False
) -> Union[Optional[torch.Tensor], Tuple[Optional[torch.Tensor], torch.Tensor]]:
    """RMSE over a sliding window.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import root_mean_squared_error_using_sliding_window
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> round(float(root_mean_squared_error_using_sliding_window(preds, preds * 0.75 + 0.1)), 2)
        0.08
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse
