"""Modular log-cosh error (counterpart of ``torchmetrics_tpu/regression/log_cosh.py``).

``sum_log_cosh_error`` has shape ``(num_outputs,)`` and ``total`` is a float of shape
(1,), as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.regression.mse import _num_outputs_validation


class LogCoshError(Metric):
    """Log-cosh error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import LogCoshError
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(LogCoshError(device="cpu")(preds, target)), 4)
        0.1685
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _num_outputs_validation(num_outputs)
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(1), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the log-cosh errors and the row count."""
        sum_log_cosh_error, n_obs = _log_cosh_error_update(preds, target, self.num_outputs)
        self.sum_log_cosh_error = self.sum_log_cosh_error + sum_log_cosh_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        """The mean log-cosh error."""
        return _log_cosh_error_compute(self.sum_log_cosh_error, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
