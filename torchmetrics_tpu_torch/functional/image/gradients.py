"""Image gradients by finite differences (counterpart of ``torchmetrics_tpu/functional/image/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _image_gradients_validate(img: torch.Tensor) -> None:
    """A 4-D tensor."""
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dy, dx)``, the last row of dy and the last column of dx zero."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite-difference gradients of an NCHW batch.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import image_gradients
        >>> dy, dx = image_gradients(torch.arange(25.0).reshape(1, 1, 5, 5))
        >>> dy[0, 0, :, 0].tolist(), dx[0, 0, 0].tolist()
        ([5.0, 5.0, 5.0, 5.0, 0.0], [1.0, 1.0, 1.0, 1.0, 0.0])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
