"""Total variation (counterpart of ``torchmetrics_tpu/functional/image/tv.py``)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def _total_variation_update(img: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Per-image anisotropic total variation and the image count."""
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {img.shape}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = diff1.abs().sum(dim=(1, 2, 3))
    res2 = diff2.abs().sum(dim=(1, 2, 3))
    return res1 + res2, img.shape[0]


def _total_variation_compute(
    score: torch.Tensor, num_elements: Union[int, torch.Tensor], reduction: Optional[str]
) -> torch.Tensor:
    """Reduce the accumulated scores."""
    if reduction == "mean":
        return score.sum() / num_elements
    if reduction == "sum":
        return score.sum()
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Total variation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import total_variation
        >>> float(total_variation(torch.arange(16.0).reshape(1, 1, 4, 4)))
        60.0
    """
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)
