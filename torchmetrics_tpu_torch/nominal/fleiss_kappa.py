"""Modular Fleiss' kappa (counterpart of ``torchmetrics_tpu/nominal/fleiss_kappa.py``).

A ``cat`` list of per-sample count rows; under the engine its update falls back, as a
list state does in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import _fleiss_kappa_compute, _fleiss_kappa_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class FleissKappa(Metric):
    """Fleiss' kappa, the agreement of raters on categories.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> ratings = torch.tensor([[2, 1, 0], [1, 1, 1], [0, 2, 1], [3, 0, 0]])
        >>> metric = FleissKappa(mode="counts", device="cpu")
        >>> metric.update(ratings)
        >>> round(float(metric.compute()), 4)
        0.0455
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    counts: List[torch.Tensor]

    def __init__(self, mode: str = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of ['counts', 'probs']")
        self.mode = mode
        self.add_state("counts", default=[], dist_reduce_fx="cat")

    def update(self, ratings: torch.Tensor) -> None:
        """Append the per-sample category counts of one batch."""
        self.counts.append(_fleiss_kappa_update(ratings, self.mode))

    def compute(self) -> torch.Tensor:
        """Kappa over every rated sample."""
        return _fleiss_kappa_compute(dim_zero_cat(self.counts))

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
