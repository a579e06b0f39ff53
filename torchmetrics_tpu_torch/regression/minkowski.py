"""Modular Minkowski distance (counterpart of ``torchmetrics_tpu/regression/minkowski.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.minkowski import (
    _minkowski_distance_compute,
    _minkowski_distance_update,
    _minkowski_p_validation,
)
from torchmetrics_tpu_torch.metric import Metric


class MinkowskiDistance(Metric):
    """Minkowski distance of order ``p``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MinkowskiDistance
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(MinkowskiDistance(p=3.0, device="cpu")(preds, target)), 4)
        1.0772
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _minkowski_p_validation(p)
        self.p = p
        self.add_state("minkowski_dist_sum", 0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, targets: torch.Tensor) -> None:
        """Accumulate Σ |error|^p."""
        self.minkowski_dist_sum = self.minkowski_dist_sum + _minkowski_distance_update(preds, targets, self.p)

    def compute(self) -> torch.Tensor:
        """The p-th root of the accumulated sum."""
        return _minkowski_distance_compute(self.minkowski_dist_sum, self.p)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
