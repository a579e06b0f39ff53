"""Modular explained variance (counterpart of ``torchmetrics_tpu/regression/explained_variance.py``).

Five float sums (0-d, or per output once a 2-D batch arrives), the row count among
them, sum-reduced.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.explained_variance import (
    ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from torchmetrics_tpu_torch.metric import Metric


class ExplainedVariance(Metric):
    """Explained variance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ExplainedVariance
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(ExplainedVariance(device="cpu")(preds, target)), 4)
        0.9572
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}"
            )
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, 0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the five moment sums."""
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> torch.Tensor:
        """The explained variance under the ``multioutput`` reduction."""
        return _explained_variance_compute(
            self.n_obs, self.sum_error, self.sum_squared_error, self.sum_target, self.sum_squared_target,
            self.multioutput,
        )

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
