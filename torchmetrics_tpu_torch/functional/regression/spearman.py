"""Spearman rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/spearman.py``).

Tied values share their mean rank, from one sort and two ``searchsorted`` calls over
every column at once. The rank sums are int64 and the ranks and the correlation
float64, rounded once to float32 at the end: float32 ranks are inexact past 2^24 rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.data import _order_keys


def _rank_data(data: torch.Tensor) -> torch.Tensor:
    """Float64 average rank of each element along dim 0 (each column of a 2-D input on
    its own): (values < x) + (values <= x) + 1, halved. The search runs over integer
    keys that order as the JAX package's sort does (NaN last, all NaN tied)."""
    columns = _order_keys(data.reshape(data.shape[0], -1).T.contiguous())
    sorted_data = torch.sort(columns, dim=-1).values
    lower = torch.searchsorted(sorted_data, columns, right=False)
    upper = torch.searchsorted(sorted_data, columns, right=True)
    return ((lower + upper + 1) / 2.0).to(torch.float64).T.reshape(data.shape)


def _spearman_corrcoef_update(
    preds: torch.Tensor, target: torch.Tensor, num_outputs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs; the raw values go into the list states."""
    if not (preds.is_floating_point() and target.is_floating_point()):
        raise TypeError(
            "Expected `preds` and `target` both to be floating point tensors, but got"
            f" {preds.dtype} and {target.dtype}"
        )
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return preds, target


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Pearson's r of the ranks, clipped to [-1, 1], as float32."""
    preds = _rank_data(preds)
    target = _rank_data(target)
    preds_diff = preds - preds.mean(0)
    target_diff = target - target.mean(0)
    cov = (preds_diff * target_diff).mean(0)
    preds_std = torch.sqrt((preds_diff * preds_diff).mean(0))
    target_std = torch.sqrt((target_diff * target_diff).mean(0))
    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0).to(torch.float32)


def spearman_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman's ρ.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spearman_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(spearman_corrcoef(preds, target)), 4)
        1.0
    """
    preds, target = _spearman_corrcoef_update(preds, target, num_outputs=1 if preds.ndim == 1 else preds.shape[-1])
    return _spearman_corrcoef_compute(preds, target)
