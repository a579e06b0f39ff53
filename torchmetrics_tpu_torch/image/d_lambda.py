"""Modular spectral distortion index D_lambda (counterpart of ``torchmetrics_tpu/image/d_lambda.py``).

``cat`` lists of the batches; the value is computed over all of them at ``compute``.
Under the engine the update falls back, as a list state does in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.image.d_lambda import (
    _spectral_distortion_index_compute,
    _spectral_distortion_index_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class SpectralDistortionIndex(Metric):
    """Spectral distortion index D_lambda.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralDistortionIndex
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = SpectralDistortionIndex(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> round(float(metric.compute()), 4)
        0.001
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        allowed_reductions = ("elementwise_mean", "sum", "none")
        if reduction not in allowed_reductions:
            raise ValueError(f"Expected argument `reduction` be one of {allowed_reductions} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Keep one batch of image pairs."""
        preds, target = _spectral_distortion_index_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """The value over every kept batch."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _spectral_distortion_index_compute(preds, target, self.p, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
