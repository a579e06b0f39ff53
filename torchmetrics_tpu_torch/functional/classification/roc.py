"""Multiclass ROC curves (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _binary_clf_curve
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _binary_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fpr / tpr / thresholds of one class, binned or exact."""
    if isinstance(state, torch.Tensor) and thresholds is not None:
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        tns = state[:, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0)
        fpr = _safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)

    preds, target = state
    keep = target >= 0
    preds, target = preds[keep], target[keep]
    fps, tps, thresh = _binary_clf_curve(preds, target, pos_label=pos_label)
    # prepend a point so the curve starts at (0, 0)
    tps = torch.cat([tps.new_zeros(1), tps])
    fps = torch.cat([fps.new_zeros(1), fps])
    thresh = torch.cat([thresh.new_ones(1), thresh])
    if float(fps[-1]) <= 0:
        rank_zero_warn(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros_like(thresh)
    else:
        fpr = fps / fps[-1]
    if float(tps[-1]) <= 0:
        rank_zero_warn(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros_like(thresh)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresh


def _multiclass_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    thresholds: Optional[torch.Tensor],
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """Per-class fpr / tpr: ``(C, T)`` tensors when binned, lists when exact."""
    if isinstance(state, torch.Tensor) and thresholds is not None:
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        tns = state[:, :, 0, 0]
        tpr = _safe_divide(tps, tps + fns).flip(0).T
        fpr = _safe_divide(fps, fps + tns).flip(0).T
        return fpr, tpr, thresholds.flip(0)

    fpr, tpr, thresh = [], [], []
    for i in range(num_classes):
        res = _binary_roc_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
        fpr.append(res[0])
        tpr.append(res[1])
        thresh.append(res[2])
    return fpr, tpr, thresh
