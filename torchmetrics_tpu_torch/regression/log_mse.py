"""Modular mean squared log error (counterpart of ``torchmetrics_tpu/regression/log_mse.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.log_mse import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)
from torchmetrics_tpu_torch.metric import Metric


class MeanSquaredLogError(Metric):
    """MSLE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredLogError
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(MeanSquaredLogError(device="cpu")(preds, target)), 4)
        0.0286
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the squared log errors and the element count."""
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """The mean squared log error."""
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
