"""Modular Theil's U (counterpart of ``torchmetrics_tpu/nominal/theils_u.py``).

An int32 ``(C, C)`` ``confmat`` state, sum-reduced, as ``cramers.py`` has.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.nominal.theils_u import _theils_u_compute, _theils_u_update
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.metric import Metric


class TheilsU(Metric):
    """Theil's U, the asymmetric uncertainty coefficient of two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TheilsU
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 2, 1, 2, 0, 0])
        >>> metric = TheilsU(num_classes=3, device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.5869
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    confmat: torch.Tensor

    def __init__(
        self,
        num_classes: int,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[Union[int, float]] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Count a batch of label pairs into the table."""
        confmat = _theils_u_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        """Theil's U over the accumulated table."""
        return _theils_u_compute(self.confmat)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
