"""Universal image quality index (counterpart of ``torchmetrics_tpu/functional/image/uqi.py``).

One gaussian band filter over the stacked five moment maps, as SSIM.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.helper import (
    _check_image_shape,
    _filter_separable_2d,
    _gaussian_np,
    _reflect_pad_2d,
)
from torchmetrics_tpu_torch.utilities.distributed import reduce


def _uqi_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check BxCxHxW inputs of one dtype."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    return _check_image_shape(preds, target)


def _uqi_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """UQI over gaussian-windowed moments."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    preds = _reflect_pad_2d(preds, pad_h, pad_w)
    target = _reflect_pad_2d(target, pad_h, pad_w)

    input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])
    outputs = _filter_separable_2d(
        input_list, _gaussian_np(kernel_size[0], sigma[0]), _gaussian_np(kernel_size[1], sigma[1])
    )
    mu_pred, mu_target, e_pp, e_tt, e_pt = outputs.split(preds.shape[0])

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq + torch.finfo(sigma_pred_sq.dtype).eps

    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Universal image quality index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import universal_image_quality_index
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> round(float(universal_image_quality_index(preds, preds * 0.75 + 0.1)), 2)
        0.96
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
