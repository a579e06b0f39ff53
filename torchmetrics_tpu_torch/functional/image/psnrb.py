"""PSNR with the blocking effect (counterpart of ``torchmetrics_tpu/functional/image/psnrb.py``).

The block-boundary and in-block differences are summed under boolean masks of the
columns and rows, cached per ``(length, block size, device)`` and made on the device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.image.helper import _device_constant


def _boundary_mask(n: int, block_size: int, device: torch.device) -> torch.Tensor:
    """Of the ``n - 1`` differences along an axis of length ``n``, those across a block
    boundary: positions ``block_size - 1``, ``2 block_size - 1``, ... (bool)."""
    return _device_constant(
        ("block boundaries", n, block_size, device),
        lambda: torch.arange(n - 1, device=device) % block_size == block_size - 1,
    )


def _compute_bef(x: torch.Tensor, block_size: int = 8) -> torch.Tensor:
    """Blocking effect factor of a grayscale NCHW batch."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")

    h_b = _boundary_mask(width, block_size, x.device)
    v_b = _boundary_mask(height, block_size, x.device)[None, None, :, None]

    h_diff_sq = (x[:, :, :, :-1] - x[:, :, :, 1:]) ** 2  # (B, 1, H, W - 1)
    v_diff_sq = (x[:, :, :-1, :] - x[:, :, 1:, :]) ** 2  # (B, 1, H - 1, W)

    d_b = torch.sum(h_diff_sq * h_b) + torch.sum(v_diff_sq * v_b)
    d_bc = torch.sum(h_diff_sq * ~h_b) + torch.sum(v_diff_sq * ~v_b)

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), 0.0)


def _psnrb_compute(
    sum_squared_error: torch.Tensor, bef: torch.Tensor, n_obs: torch.Tensor, data_range: torch.Tensor
) -> torch.Tensor:
    """PSNR-B from the accumulated squared error, blocking effect and count."""
    sum_squared_error = sum_squared_error / n_obs + bef
    return torch.where(
        data_range > 2,
        10 * torch.log10(data_range**2 / sum_squared_error),
        10 * torch.log10(1.0 / sum_squared_error),
    )


def _psnrb_update(preds: torch.Tensor, target: torch.Tensor, block_size: int = 8) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The squared error, the blocking effect of ``preds`` and the count."""
    sum_squared_error = torch.sum((preds - target) ** 2)
    bef = _compute_bef(preds, block_size=block_size)
    return sum_squared_error, bef, target.numel()


def peak_signal_noise_ratio_with_blocked_effect(
    preds: torch.Tensor, target: torch.Tensor, block_size: int = 8
) -> torch.Tensor:
    """PSNR-B of grayscale images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio_with_blocked_effect
        >>> preds = torch.rand(1, 1, 28, 28, generator=torch.Generator().manual_seed(42))
        >>> target = torch.rand(1, 1, 28, 28, generator=torch.Generator().manual_seed(43))
        >>> 7.0 < float(peak_signal_noise_ratio_with_blocked_effect(preds, target)) < 8.5
        True
    """
    data_range = target.amax() - target.amin()
    sum_squared_error, bef, n_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, n_obs, data_range)
