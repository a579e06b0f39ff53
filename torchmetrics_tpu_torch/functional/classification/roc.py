"""ROC curves for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/functional/classification/roc.py``).

They share the PR curve's states (binned confusion tensors or exact score lists) and
change only the compute.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_exact_columns,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.enums import _route_task
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


def binary_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ROC for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_roc
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> [tuple(v.shape) for v in binary_roc(preds, torch.tensor([1, 0, 1, 1, 0, 0]), thresholds=5)]
        [(5,), (5,), (5,)]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_roc_compute(state, thresholds)


def _binned_roc(state: torch.Tensor, thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class ``(C, T)`` fpr / tpr from a ``(T, C, 2, 2)`` state, thresholds descending."""
    tps = state[:, :, 1, 1]
    fps = state[:, :, 0, 1]
    fns = state[:, :, 1, 0]
    tns = state[:, :, 0, 0]
    tpr = _safe_divide(tps, tps + fns).flip(0).T
    fpr = _safe_divide(fps, fps + tns).flip(0).T
    return fpr, tpr, thresholds.flip(0)


def _multiclass_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    thresholds: Optional[torch.Tensor],
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """Per-class fpr / tpr: ``(C, T)`` tensors when binned, lists when exact."""
    if isinstance(state, torch.Tensor) and thresholds is not None:
        return _binned_roc(state, thresholds)

    fpr, tpr, thresh = [], [], []
    for i in range(num_classes):
        res = _binary_roc_compute((state[0][:, i], state[1]), thresholds=None, pos_label=i)
        fpr.append(res[0])
        tpr.append(res[1])
        thresh.append(res[2])
    return fpr, tpr, thresh


def multiclass_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """ROC for multiclass tasks."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_roc_compute(state, num_classes, thresholds)


def _multilabel_roc_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """Per-label fpr / tpr: ``(L, T)`` tensors when binned, lists when exact."""
    if isinstance(state, torch.Tensor) and thresholds is not None:
        return _binned_roc(state, thresholds)
    fpr, tpr, thresh = [], [], []
    for column in _multilabel_exact_columns(state, num_labels, ignore_index):
        res = _binary_roc_compute(column, thresholds=None, pos_label=1)
        fpr.append(res[0])
        tpr.append(res[1])
        thresh.append(res[2])
    return fpr, tpr, thresh


def multilabel_roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """ROC for multilabel tasks."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task router for the ROC."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_roc(preds, target, thresholds, ignore_index, validate_args),
        lambda c: multiclass_roc(preds, target, c, thresholds, ignore_index, validate_args),
        lambda n: multilabel_roc(preds, target, n, thresholds, ignore_index, validate_args),
    )
