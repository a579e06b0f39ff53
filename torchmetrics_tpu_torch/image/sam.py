"""Modular spectral angle mapper (counterpart of ``torchmetrics_tpu/image/sam.py``).

``cat`` lists of the batches; the value is computed over all of them at ``compute``.
Under the engine the update falls back, as a list state does in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.image.sam import _sam_compute, _sam_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class SpectralAngleMapper(Metric):
    """Spectral angle mapper (SAM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import SpectralAngleMapper
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = SpectralAngleMapper(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> 0.0 < float(metric.compute()) < 0.2
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Keep one batch of image pairs."""
        preds, target = _sam_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """The value over every kept batch."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _sam_compute(preds, target, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
