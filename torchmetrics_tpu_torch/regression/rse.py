"""Modular relative squared error (counterpart of ``torchmetrics_tpu/regression/rse.py``).

A subclass of ``R2Score``: the same states, another formula at compute, so a
``MetricCollection`` puts the two in one compute group.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.rse import _relative_squared_error_compute
from torchmetrics_tpu_torch.regression.r2 import R2Score


class RelativeSquaredError(R2Score):
    """RSE.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import RelativeSquaredError
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(RelativeSquaredError(device="cpu")(preds, target)), 4)
        0.0514
    """

    higher_is_better: bool = False
    plot_upper_bound: Optional[float] = None

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(num_outputs=num_outputs, **kwargs)
        self.squared = squared

    def compute(self) -> torch.Tensor:
        """The relative squared error."""
        return _relative_squared_error_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, squared=self.squared
        )
