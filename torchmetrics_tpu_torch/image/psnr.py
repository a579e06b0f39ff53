"""Modular PSNR (counterpart of ``torchmetrics_tpu/image/psnr.py``).

Float ``sum_squared_error`` and int32 ``total`` sums when ``dim`` is None (the update
runs in a captured graph under the engine), ``cat`` lists of per-slice values
otherwise. With ``data_range=None`` the target's range is tracked in ``min_target`` /
``max_target`` states that start at 0.0 and fold with ``min`` / ``max``, as in the
JAX package; a given range is a ``data_range`` state folded with ``mean``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


class PeakSignalNoiseRatio(Metric):
    """Peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(preds, target)), 4)
        2.5527
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", 0.0, dist_reduce_fx="sum")
            self.add_state("total", 0, dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")

        self.clamping_fn = None
        self._track_range = data_range is None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.add_state("min_target", 0.0, dist_reduce_fx="min")
            self.add_state("max_target", 0.0, dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.add_state("data_range", float(data_range[1] - data_range[0]), dist_reduce_fx="mean")
            self.clamping_fn = lambda x: torch.clamp(x, data_range[0], data_range[1])
        else:
            self.add_state("data_range", float(data_range), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the squared error and the count (and the target's range when tracked)."""
        if self.clamping_fn is not None:
            preds = self.clamping_fn(preds)
            target = self.clamping_fn(target)

        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self._track_range:
                self.min_target = torch.minimum(target.amin(), self.min_target)
                self.max_target = torch.maximum(target.amax(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> torch.Tensor:
        """PSNR over the accumulated error."""
        data_range = self.max_target - self.min_target if self._track_range else self.data_range
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = dim_zero_cat(self.sum_squared_error)
            total = dim_zero_cat(self.total)
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
