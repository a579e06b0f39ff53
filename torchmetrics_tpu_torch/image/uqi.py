"""Modular universal image quality index (counterpart of ``torchmetrics_tpu/image/uqi.py``).

``cat`` lists of the batches; the value is computed over all of them at ``compute``.
Under the engine the update falls back, as a list state does in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from torchmetrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class UniversalImageQualityIndex(Metric):
    """Universal image quality index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import UniversalImageQualityIndex
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = UniversalImageQualityIndex(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> round(float(metric.compute()), 2)
        0.96
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Keep one batch of image pairs."""
        preds, target = _uqi_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """The value over every kept batch."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _uqi_compute(preds, target, self.kernel_size, self.sigma, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
