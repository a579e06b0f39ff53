"""Multiclass AUROC (counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.roc import _multiclass_roc_compute
from torchmetrics_tpu_torch.utilities.compute import _auc_compute_without_check, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _bincount
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _reduce_auroc(
    fpr: Union[torch.Tensor, List[torch.Tensor]],
    tpr: Union[torch.Tensor, List[torch.Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce per-class AUCs; NaN classes are left out of the average."""
    if isinstance(fpr, torch.Tensor):
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
    if average is None or average == "none":
        return res
    if bool(torch.isnan(res).any()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    idx = ~torch.isnan(res)
    if average == "macro":
        return torch.where(idx, res, 0.0).sum() / idx.sum()
    if average == "weighted" and weights is not None:
        w = _safe_divide(torch.where(idx, weights, 0.0), torch.where(idx, weights, 0.0).sum())
        return (torch.where(idx, res, 0.0) * w).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None) but got {average}"
        )


def _multiclass_auroc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    if thresholds is None:
        target = state[1]
        weights = _bincount(target[target >= 0], minlength=num_classes).to(torch.float32)
    else:
        # tp + fn (positives per class) does not depend on the threshold; read it at the first
        weights = state[0][:, 1, :].sum(-1).to(torch.float32)
    return _reduce_auroc(fpr, tpr, average, weights=weights)


def multiclass_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AUROC for multiclass tasks."""
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)
