"""Spectral angle mapper (counterpart of ``torchmetrics_tpu/functional/image/sam.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.helper import _check_image_shape
from torchmetrics_tpu_torch.utilities.distributed import reduce


def _sam_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check multispectral BxCxHxW inputs (C > 1) of one dtype."""
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_image_shape(preds, target)
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """The spectral angle of every pixel, reduced."""
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1.0, 1.0))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "elementwise_mean"
) -> torch.Tensor:
    """Spectral angle mapper (SAM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spectral_angle_mapper
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> 0.0 < float(spectral_angle_mapper(preds, preds * 0.75 + 0.1)) < 0.2
        True
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
