"""Modular mean squared error (counterpart of ``torchmetrics_tpu/regression/mse.py``).

A float ``sum_squared_error`` (0-d at one output, ``(num_outputs,)`` otherwise) and
an int32 ``total``, sum-reduced; the update runs in a captured graph under the engine.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from torchmetrics_tpu_torch.metric import Metric


def _num_outputs_validation(num_outputs: int) -> None:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Expected num_outputs to be a positive integer but got {num_outputs}")


class MeanSquaredError(Metric):
    """MSE (RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanSquaredError
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> float(MeanSquaredError(device="cpu")(preds, target))
        0.875
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared
        _num_outputs_validation(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_squared_error", torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the squared errors and the row count."""
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target, num_outputs=self.num_outputs)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """The mean (root) squared error."""
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
