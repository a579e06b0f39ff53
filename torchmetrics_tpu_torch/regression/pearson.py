"""Modular Pearson correlation (counterpart of ``torchmetrics_tpu/regression/pearson.py``).

Six ``(num_outputs,)`` moment states with ``dist_reduce_fx=None``: a sync or a
``merge_state`` stacks them per shard, ``(shards, num_outputs)``, and ``compute`` merges
the stacked rows with ``_final_aggregation``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.metric import Metric

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson r from streaming moments.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PearsonCorrCoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(PearsonCorrCoef(device="cpu")(preds, target)), 4)
        0.9849
    """

    is_differentiable: bool = True
    higher_is_better: Optional[bool] = None  # both +1 and -1 are "good"
    full_state_update: bool = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for name in _MOMENTS:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """One streaming-moment step."""
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total,
            self.num_outputs,
        )

    def _merged_moments(self) -> Tuple[torch.Tensor, ...]:
        """The states as one set of moments, merging stacked per-shard rows if present.

        Decided from the shapes, as the JAX package decides: a state carried in from a
        JAX state dict has no record of having been stacked. Shared by
        ``ConcordanceCorrCoef``.
        """
        moments = tuple(getattr(self, name) for name in _MOMENTS)
        if (self.num_outputs == 1 and self.mean_x.numel() > 1) or (self.num_outputs > 1 and self.mean_x.ndim > 1):
            return _final_aggregation(*moments)
        return moments

    def compute(self) -> torch.Tensor:
        """The correlation."""
        _, _, var_x, var_y, corr_xy, n_total = self._merged_moments()
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
