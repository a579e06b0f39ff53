"""Shared running-mean base of the audio metrics (counterpart of
``torchmetrics_tpu/audio/_mean_base.py``): a float ``sum_value`` and an int32
``total``, both summed across processes, averaged at ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric


class _MeanOfBatchValues(Metric):
    """Accumulate ``values.sum()`` and ``values.numel()`` and average at compute."""

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False

    sum_value: torch.Tensor
    total: torch.Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_value", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update_from_values(self, values: torch.Tensor) -> None:
        # a float64 batch (SDR of float64 inputs) adds into the state's own dtype
        self.sum_value = self.sum_value + values.sum().to(self.sum_value.dtype)
        self.total = self.total + values.numel()

    def compute(self) -> torch.Tensor:
        """Average over every element seen."""
        return self.sum_value / self.total

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
