"""Modular Cramér's V (counterpart of ``torchmetrics_tpu/nominal/cramers.py``).

An int32 ``(C, C)`` ``confmat`` state, sum-reduced; the update reads nothing back, so
it runs as a captured graph under the engine (``nan_strategy="drop"`` too), and
``compute`` reads the table once.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.nominal.cramers import _cramers_v_compute, _cramers_v_update
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.metric import Metric


class CramersV(Metric):
    """Cramér's V between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> preds = torch.tensor([0, 1, 2, 1, 0, 2, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 2, 0, 2, 1, 2, 0, 0])
        >>> cramers_v = CramersV(num_classes=3, device="cpu")
        >>> round(float(cramers_v(preds, target)), 4)
        0.6614
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
        bias_correction: bool = True,
        nan_strategy: str = "replace",
        nan_replace_value: Optional[Union[int, float]] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.bias_correction = bias_correction
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Count a batch of label pairs into the table."""
        confmat = _cramers_v_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        """Cramér's V over the accumulated table."""
        return _cramers_v_compute(self.confmat, self.bias_correction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
