"""Modular MAPE, SMAPE and WMAPE (counterpart of ``torchmetrics_tpu/regression/mape.py``):
plain sum states, one module, exported separately."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.mape import (
    _mean_absolute_percentage_error_compute,
    _mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.functional.regression.symmetric_mape import (
    _symmetric_mean_absolute_percentage_error_compute,
    _symmetric_mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.functional.regression.wmape import (
    _weighted_mean_absolute_percentage_error_compute,
    _weighted_mean_absolute_percentage_error_update,
)
from torchmetrics_tpu_torch.metric import Metric


class _PercentageError(Metric):
    """A ``sum_abs_per_error`` sum and an element count, through the subclass's pair of
    update and compute functions."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    _update_fn = None  # set by each subclass
    _compute_fn = None

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the percentage errors and the element count."""
        sum_abs_per_error, num_obs = type(self)._update_fn(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + sum_abs_per_error
        self.total = self.total + num_obs

    def compute(self) -> torch.Tensor:
        """The mean percentage error."""
        return type(self)._compute_fn(self.sum_abs_per_error, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class MeanAbsolutePercentageError(_PercentageError):
    """MAPE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsolutePercentageError
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(MeanAbsolutePercentageError(device="cpu")(preds, target)), 4)
        0.3274
    """

    _update_fn = staticmethod(_mean_absolute_percentage_error_update)
    _compute_fn = staticmethod(_mean_absolute_percentage_error_compute)


class SymmetricMeanAbsolutePercentageError(_PercentageError):
    """SMAPE."""

    plot_upper_bound: float = 2.0
    _update_fn = staticmethod(_symmetric_mean_absolute_percentage_error_update)
    _compute_fn = staticmethod(_symmetric_mean_absolute_percentage_error_compute)


class WeightedMeanAbsolutePercentageError(Metric):
    """WMAPE."""

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", 0.0, dist_reduce_fx="sum")
        self.add_state("sum_scale", 0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate Σ |error| and Σ |target|."""
        sum_abs_error, sum_scale = _weighted_mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.sum_scale = self.sum_scale + sum_scale

    def compute(self) -> torch.Tensor:
        """The weighted mean absolute percentage error."""
        return _weighted_mean_absolute_percentage_error_compute(self.sum_abs_error, self.sum_scale)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
