"""Modular concordance correlation (counterpart of ``torchmetrics_tpu/regression/concordance.py``).

A ``PearsonCorrCoef`` with another final formula: the same moment states, so a
``MetricCollection`` puts both in one compute group.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef


class ConcordanceCorrCoef(PearsonCorrCoef):
    """The concordance correlation coefficient from the Pearson moments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ConcordanceCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        0.9777
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        """The concordance correlation."""
        return _concordance_corrcoef_compute(*self._merged_moments())

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
