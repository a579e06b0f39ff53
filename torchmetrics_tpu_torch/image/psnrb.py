"""Modular PSNR-B (counterpart of ``torchmetrics_tpu/image/psnrb.py``).

Four float sums (``data_range`` folds with ``max``); the update runs in a captured
graph under the engine.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update
from torchmetrics_tpu_torch.metric import Metric


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B of grayscale images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import PeakSignalNoiseRatioWithBlockedEffect
        >>> gen = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(2, 1, 28, 28, generator=gen), torch.rand(2, 1, 28, 28, generator=gen)
        >>> metric = PeakSignalNoiseRatioWithBlockedEffect(device="cpu")
        >>> metric.update(preds, target)
        >>> 7.0 < float(metric.compute()) < 8.5
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")
        self.add_state("bef", 0.0, dist_reduce_fx="sum")
        self.add_state("data_range", 0.0, dist_reduce_fx="max")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the squared error, the blocking effect and the count; keep the largest range."""
        sum_squared_error, bef, n_obs = _psnrb_update(preds, target, block_size=self.block_size)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.bef = self.bef + bef
        self.total = self.total + n_obs
        self.data_range = torch.maximum(self.data_range, target.amax() - target.amin())

    def compute(self) -> torch.Tensor:
        """PSNR-B over the accumulated statistics."""
        return _psnrb_compute(self.sum_squared_error, self.bef, self.total, self.data_range)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
