"""Modular RMSE over a sliding window (counterpart of ``torchmetrics_tpu/image/rmse_sw.py``).

Two float sums; the update runs in a captured graph under the engine.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update
from torchmetrics_tpu_torch.metric import Metric


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """RMSE over a sliding window.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RootMeanSquaredErrorUsingSlidingWindow
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = RootMeanSquaredErrorUsingSlidingWindow(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> round(float(metric.compute()), 2)
        0.08
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", 0.0, dist_reduce_fx="sum")
        self.add_state("total_images", 0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the batch's windowed RMSE sum and image count."""
        rmse_val_sum, _, total_images = _rmse_sw_update(
            preds, target, self.window_size, rmse_val_sum=None, rmse_map=None, total_images=None
        )
        self.rmse_val_sum = self.rmse_val_sum + rmse_val_sum
        self.total_images = self.total_images + total_images

    def compute(self) -> Optional[torch.Tensor]:
        """The mean windowed RMSE."""
        rmse, _ = _rmse_sw_compute(self.rmse_val_sum, rmse_map=None, total_images=self.total_images)
        return rmse

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
