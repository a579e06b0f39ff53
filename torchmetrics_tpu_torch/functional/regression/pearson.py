"""Pearson correlation from streaming moments (counterpart of
``torchmetrics_tpu/functional/regression/pearson.py``).

The state is ``(mean_x, mean_y, var_x, var_y, corr_xy, n)``, updated batch by batch;
``_final_aggregation`` merges per-shard moments pairwise, for the modular class's
stacked ``dist_reduce_fx=None`` states and for ``merge_state``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    n_prior: torch.Tensor,
    num_outputs: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming-moment step.

    Branch-free, as in the JAX package: ``torch.where`` selects between the running
    increment and the two-pass increment centred at the batch mean, which the first
    batch takes. A Python ``if n_prior > 0`` would read the host, and the engine would
    run the update eagerly.
    """
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    cond = n_prior > 0
    n_obs = preds.shape[0]
    n_total = n_prior + n_obs
    mx_batch = preds.mean(0)
    my_batch = target.mean(0)
    mx_new = torch.where(cond, (n_prior * mean_x + preds.sum(0)) / n_total, mx_batch)
    my_new = torch.where(cond, (n_prior * mean_y + target.sum(0)) / n_total, my_batch)
    var_x = var_x + torch.where(
        cond,
        ((preds - mx_new) * (preds - mean_x)).sum(0),
        ((preds - mx_batch) ** 2).sum(0),
    )
    var_y = var_y + torch.where(
        cond,
        ((target - my_new) * (target - mean_y)).sum(0),
        ((target - my_batch) ** 2).sum(0),
    )
    corr_xy = corr_xy + torch.where(
        cond,
        ((preds - mx_new) * (target - mean_y)).sum(0),
        ((preds - mx_batch) * (target - my_batch)).sum(0),
    )
    return mx_new, my_new, var_x, var_y, corr_xy, n_total


def _pearson_corrcoef_compute(
    var_x: torch.Tensor, var_y: torch.Tensor, corr_xy: torch.Tensor, nb: torch.Tensor
) -> torch.Tensor:
    """The correlation from accumulated moments, clipped to [-1, 1]."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return torch.clamp(corrcoef, -1.0, 1.0)


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pairwise merge of per-shard moments stacked along dim 0, left to right."""
    if len(means_x) == 1:
        return means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, len(means_x)):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb

        element_x1 = (n1 + 1) * mean_x - n1 * mx1
        vx1 = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
        element_x2 = (n2 + 1) * mean_x - n2 * mx2
        vx2 = vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
        var_x = vx1 + vx2

        element_y1 = (n1 + 1) * mean_y - n1 * my1
        vy1 = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
        element_y2 = (n2 + 1) * mean_y - n2 * my2
        vy2 = vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
        var_y = vy1 + vy2

        cxy1 = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
        cxy2 = cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
        corr_xy = cxy1 + cxy2

        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return mean_x, mean_y, var_x, var_y, corr_xy, nb


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson r.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearson_corrcoef
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(pearson_corrcoef(preds, target)), 4)
        0.9849
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    _temp = torch.zeros(d, device=preds.device).squeeze()
    mean_x, mean_y, var_x = _temp, _temp, _temp
    var_y, corr_xy, nb = _temp, _temp, _temp
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, mean_x, mean_y, var_x, var_y, corr_xy, nb,
        num_outputs=1 if preds.ndim == 1 else preds.shape[-1],
    )
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
