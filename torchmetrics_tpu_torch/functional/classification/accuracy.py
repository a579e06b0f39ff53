"""Accuracy for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_pipeline,
    _multiclass_stat_scores_pipeline,
    _multilabel_stat_scores_pipeline,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide, _sum_axis
from torchmetrics_tpu_torch.utilities.enums import _check_task_size, _route_task


def _accuracy_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    """Reduce tp/fp/tn/fn into an accuracy score."""
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp = _sum_axis(tp, axis)
        fn = _sum_axis(fn, axis)
        if multilabel:
            fp = _sum_axis(fp, axis)
            tn = _sum_axis(tn, axis)
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def binary_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Accuracy for binary tasks."""
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Accuracy for multiclass tasks."""
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Accuracy for multilabel tasks."""
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router: ``binary_accuracy``, ``multiclass_accuracy`` or ``multilabel_accuracy``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import accuracy
        >>> float(accuracy(torch.tensor([0, 2, 1, 3]), torch.tensor([0, 1, 2, 3]), task="multiclass", num_classes=4))
        0.5
    """
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args),
        lambda c: multiclass_accuracy(
            preds, target, c, average, _check_task_size("top_k", top_k), multidim_average, ignore_index,
            validate_args,
        ),
        lambda n: multilabel_accuracy(
            preds, target, n, threshold, average, multidim_average, ignore_index, validate_args
        ),
    )
