"""Modular cosine similarity (counterpart of ``torchmetrics_tpu/regression/cosine_similarity.py``).

``cat`` list states: the rows are kept until ``compute``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class CosineSimilarity(Metric):
    """Row-wise cosine similarity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CosineSimilarity
        >>> preds = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        >>> target = torch.tensor([[1.0, 2.5], [2.5, 4.0], [5.5, 6.5]])
        >>> metric = CosineSimilarity(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        2.9929
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append one batch of rows."""
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """Cosine similarity under the chosen reduction."""
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
