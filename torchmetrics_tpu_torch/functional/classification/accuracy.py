"""Multiclass accuracy (counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _multiclass_stat_scores_pipeline
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide, _sum_axis


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
