"""Modular mean absolute error (counterpart of ``torchmetrics_tpu/regression/mae.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from torchmetrics_tpu_torch.metric import Metric


class MeanAbsoluteError(Metric):
    """MAE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanAbsoluteError
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> float(MeanAbsoluteError(device="cpu")(preds, target))
        0.5
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the absolute errors and the element count."""
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """The mean absolute error."""
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
