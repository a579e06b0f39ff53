"""Peak signal-to-noise ratio (counterpart of ``torchmetrics_tpu/functional/image/psnr.py``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.utilities.distributed import reduce
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    n_obs: Union[int, torch.Tensor],
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> torch.Tensor:
    """PSNR from the accumulated squared error and count."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    return reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[torch.Tensor, Union[int, torch.Tensor]]:
    """The squared error and the count, over everything or per slice left by ``dim``."""
    diff = preds - target
    if dim is None:
        return torch.sum(diff * diff), target.numel()

    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:
        return diff * diff, target.numel()
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n_obs = math.prod(target.shape[d] for d in dim_list)
    return sum_squared_error, torch.full(sum_squared_error.shape, n_obs, dtype=torch.int32, device=preds.device)


def peak_signal_noise_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """Peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(peak_signal_noise_ratio(preds, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.amax() - target.amin()
    else:
        if isinstance(data_range, tuple):
            preds = torch.clamp(preds, data_range[0], data_range[1])
            target = torch.clamp(target, data_range[0], data_range[1])
            data_range = data_range[1] - data_range[0]
        dtype = preds.dtype if preds.is_floating_point() else torch.float32
        data_range = torch.full((), float(data_range), dtype=dtype, device=preds.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
