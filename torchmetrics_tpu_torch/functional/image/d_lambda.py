"""Spectral distortion index D_lambda (counterpart of ``torchmetrics_tpu/functional/image/d_lambda.py``).

All ``C (C - 1) / 2`` channel pairs are scored in one batched UQI call over stacks of
the pairs' channels; the ``(C, C)`` matrix is written with ``index_put_`` at the upper
triangle's indices, cached per ``(C, device)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.helper import _check_image_shape, _device_constant
from torchmetrics_tpu_torch.functional.image.uqi import universal_image_quality_index
from torchmetrics_tpu_torch.utilities.distributed import reduce


def _spectral_distortion_index_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check BxCxHxW inputs of one dtype."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    return _check_image_shape(preds, target)


def _pair_indices(c: int, device: torch.device) -> torch.Tensor:
    """``(2, C (C - 1) / 2)`` row and column indices of the pairs ``k < r``, in the order
    ``[(k, r) for k in range(C) for r in range(k + 1, C)]``, made on the device."""
    return _device_constant(("pairs", c, device), lambda: torch.triu_indices(c, c, offset=1, device=device))


def _pairwise_uqi_matrix(x: torch.Tensor) -> torch.Tensor:
    """``(C, C)`` symmetric matrix of the mean UQI between every channel pair of ``x``."""
    b, c = x.shape[:2]
    m = torch.zeros((c, c), dtype=x.dtype, device=x.device)
    if c < 2:
        return m
    rows, cols = _pair_indices(c, x.device)
    stack1 = x[:, rows].transpose(0, 1).reshape(-1, 1, *x.shape[2:])  # (P*B, 1, H, W), pair-major
    stack2 = x[:, cols].transpose(0, 1).reshape(-1, 1, *x.shape[2:])
    scores = universal_image_quality_index(stack1, stack2, reduction="none")
    scores = scores.reshape(rows.shape[0], b, -1).mean(dim=(1, 2))
    m.index_put_((rows, cols), scores)
    return m + m.T


def _spectral_distortion_index_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """D_lambda from the two pairwise-UQI matrices."""
    length = preds.shape[1]
    m1 = _pairwise_uqi_matrix(target)
    m2 = _pairwise_uqi_matrix(preds)

    diff = torch.abs(m1 - m2) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    p: int = 1,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """Spectral distortion index D_lambda.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spectral_distortion_index
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> round(float(spectral_distortion_index(preds, preds * 0.75 + 0.1)), 4)
        0.001
    """
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_update(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
