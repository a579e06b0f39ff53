"""Modular relative average spectral error (counterpart of ``torchmetrics_tpu/image/rase.py``).

``cat`` lists of the batches; the windowed maps are computed over all of them at
``compute``. Under the engine the update falls back, as a list state does in the JAX
package.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.image.rase import _rase_compute, _rase_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class RelativeAverageSpectralError(Metric):
    """Relative average spectral error (RASE).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import RelativeAverageSpectralError
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = RelativeAverageSpectralError(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> float(metric.compute()) > 0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Keep one batch of image pairs."""
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """RASE over every kept batch."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        rmse_map, target_sum, total_images = _rase_update(
            preds, target, self.window_size, rmse_map=None, target_sum=None, total_images=None
        )
        return _rase_compute(rmse_map, target_sum, total_images, self.window_size)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
