"""Average precision for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``).

``AP = -sum((R[n+1] - R[n]) * P[n])`` over the PR curve of the shared PR-curve states
(the curve runs from recall 1 down to recall 0).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.classification.auroc import (
    CurveState,
    _class_weights,
    _multilabel_class_weights,
    _multilabel_micro_state,
    _reduce_class_scores,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _ap_from_curve(precision: torch.Tensor, recall: torch.Tensor) -> torch.Tensor:
    return -((recall[1:] - recall[:-1]) * precision[:-1]).sum()


def _reduce_average_precision(
    precision: Union[torch.Tensor, List[torch.Tensor]],
    recall: Union[torch.Tensor, List[torch.Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce per-class APs; NaN classes are left out of the average."""
    if isinstance(precision, torch.Tensor):
        res = -((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1]).sum(dim=1)
    else:
        res = torch.stack([_ap_from_curve(p, r) for p, r in zip(precision, recall)])
    return _reduce_class_scores(res, average, weights)


def _binary_average_precision_compute(
    state: CurveState, thresholds: Optional[torch.Tensor], pos_label: int = 1
) -> torch.Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _ap_from_curve(precision, recall)


def binary_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AP for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_average_precision
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_average_precision(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.9167
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_arg_validation(
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


def _multiclass_average_precision_compute(
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _reduce_average_precision(precision, recall, average, weights=_class_weights(state, num_classes))


def multiclass_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AP for multiclass tasks."""
    if validate_args:
        _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds)


def _multilabel_average_precision_arg_validation(
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None) but got {average}"
        )


def _multilabel_average_precision_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    if average == "micro":
        return _binary_average_precision_compute(_multilabel_micro_state(state, ignore_index), thresholds)
    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_average_precision(precision, recall, average, weights=_multilabel_class_weights(state))


def multilabel_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AP for multilabel tasks (``average="macro"`` is the mAP of multilabel image classification)."""
    if validate_args:
        _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds, ignore_index)


def average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for average precision."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_average_precision(preds, target, thresholds, ignore_index, validate_args),
        lambda c: multiclass_average_precision(preds, target, c, average, thresholds, ignore_index, validate_args),
        lambda n: multilabel_average_precision(preds, target, n, average, thresholds, ignore_index, validate_args),
    )
