"""Modular KL divergence (counterpart of ``torchmetrics_tpu/regression/kl_divergence.py``).

A float32 sum state for the ``mean`` and ``sum`` reductions, a ``cat`` list of per-row
values for ``none``; the row count is an int32 sum.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.kl_divergence import _kld_compute, _kld_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class KLDivergence(Metric):
    """KL(P‖Q).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import KLDivergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
        >>> round(float(KLDivergence(device="cpu")(p, q)), 4)
        0.0853
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction

        if self.reduction in ("mean", "sum"):
            self.add_state("measures", 0.0, dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, p: torch.Tensor, q: torch.Tensor) -> None:
        """Accumulate the rows' KL values and their count."""
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """KL divergence under the chosen reduction."""
        if self.reduction in ("mean", "sum"):
            return _kld_compute(torch.atleast_1d(self.measures), self.total, self.reduction)
        return _kld_compute(dim_zero_cat(self.measures), self.total, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
