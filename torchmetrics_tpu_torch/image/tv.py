"""Modular total variation (counterpart of ``torchmetrics_tpu/image/tv.py``).

A float ``score`` sum for ``sum`` / ``mean`` (the update runs in a captured graph under
the engine), a ``cat`` list for ``none``; an int32 ``num_elements`` count.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class TotalVariation(Metric):
    """Total variation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import TotalVariation
        >>> metric = TotalVariation(device="cpu")
        >>> float(metric(torch.arange(16.0).reshape(1, 1, 4, 4)))
        60.0
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction

        if self.reduction is None or self.reduction == "none":
            self.add_state("score", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", 0.0, dist_reduce_fx="sum")
        self.add_state("num_elements", 0, dist_reduce_fx="sum")

    def update(self, img: torch.Tensor) -> None:
        """Add the per-image total variation of one batch."""
        score, num_elements = _total_variation_update(img)
        if self.reduction is None or self.reduction == "none":
            self.score.append(score)
        else:
            self.score = self.score + score.sum()
        self.num_elements = self.num_elements + num_elements

    def compute(self) -> Union[torch.Tensor, List[torch.Tensor]]:
        """The summed, mean or per-image total variation."""
        if self.reduction is None or self.reduction == "none":
            return dim_zero_cat(self.score)
        return _total_variation_compute(torch.atleast_1d(self.score), self.num_elements, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
