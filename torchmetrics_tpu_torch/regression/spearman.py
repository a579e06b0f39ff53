"""Modular Spearman correlation (counterpart of ``torchmetrics_tpu/regression/spearman.py``).

The raw values go into ``cat`` list states; the ranking needs the whole stream, so it
runs in ``compute``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class SpearmanCorrCoef(Metric):
    """Spearman's ρ.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SpearmanCorrCoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(SpearmanCorrCoef(device="cpu")(preds, target)), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append one batch of raw values."""
        preds, target = _spearman_corrcoef_update(preds, target, self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """Rank the whole stream and correlate the ranks."""
        return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
