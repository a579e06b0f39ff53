"""Modular R² score (counterpart of ``torchmetrics_tpu/regression/r2.py``).

Σy², Σy and the residual sum of squares (0-d at one output, ``(num_outputs,)``
otherwise) and an int32 row count, sum-reduced.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import _ALLOWED_MULTIOUTPUT, _r2_score_compute, _r2_score_update
from torchmetrics_tpu_torch.metric import Metric


class R2Score(Metric):
    """R², optionally adjusted.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import R2Score
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(R2Score(device="cpu")(preds, target)), 4)
        0.9486
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in _ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {_ALLOWED_MULTIOUTPUT}"
            )
        self.multioutput = multioutput
        for name in ("sum_squared_error", "sum_error", "residual"):
            self.add_state(name, torch.zeros(num_outputs).squeeze(), dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate Σy², Σy, the residual sum of squares and the row count."""
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """The R² score."""
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
