"""Precision and recall for binary, multiclass and multilabel tasks, and their task
routers (counterpart of ``torchmetrics_tpu/functional/classification/precision_recall.py``).

Each is a reduce of the stat-scores counters: precision divides by ``tp + fp``, recall
by ``tp + fn``. The multiclass members run kernel K1 where its gate admits the inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_pipeline,
    _multiclass_stat_scores_pipeline,
    _multilabel_stat_scores_pipeline,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide, _sum_axis
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _precision_recall_reduce(
    stat: str,
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    """``stat`` is ``"precision"`` (divides by ``tp + fp``) or ``"recall"`` (by ``tp + fn``)."""
    different_stat = fp if stat == "precision" else fn
    if average == "binary":
        return _safe_divide(tp, tp + different_stat)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp = _sum_axis(tp, axis)
        different_stat = _sum_axis(different_stat, axis)
        return _safe_divide(tp, tp + different_stat)
    score = _safe_divide(tp, tp + different_stat)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def _binary(stat: str, preds, target, threshold, multidim_average, ignore_index, validate_args) -> torch.Tensor:
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce(stat, tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def _multiclass(
    stat: str, preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
) -> torch.Tensor:
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def _multilabel(
    stat: str, preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
) -> torch.Tensor:
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _precision_recall_reduce(
        stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
    )


def binary_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Precision = tp / (tp + fp) for binary tasks."""
    return _binary("precision", preds, target, threshold, multidim_average, ignore_index, validate_args)


def multiclass_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Precision for multiclass tasks."""
    return _multiclass(
        "precision", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Precision for multilabel tasks."""
    return _multilabel(
        "precision", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def binary_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Recall = tp / (tp + fn) for binary tasks."""
    return _binary("recall", preds, target, threshold, multidim_average, ignore_index, validate_args)


def multiclass_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Recall for multiclass tasks."""
    return _multiclass(
        "recall", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Recall for multilabel tasks."""
    return _multilabel(
        "recall", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def _route(
    stat: str,
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    multidim_average: str,
    top_k: int,
    ignore_index: Optional[int],
    validate_args: bool,
) -> torch.Tensor:
    return _route_task(
        task, num_classes, num_labels,
        lambda: _binary(stat, preds, target, threshold, multidim_average, ignore_index, validate_args),
        lambda c: _multiclass(
            stat, preds, target, c, average, top_k, multidim_average, ignore_index, validate_args
        ),
        lambda n: _multilabel(
            stat, preds, target, n, threshold, average, multidim_average, ignore_index, validate_args
        ),
    )


def precision(
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
    """Task router for precision."""
    return _route(
        "precision", preds, target, task, threshold, num_classes, num_labels,
        average, multidim_average, top_k, ignore_index, validate_args,
    )


def recall(
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
    """Task router for recall."""
    return _route(
        "recall", preds, target, task, threshold, num_classes, num_labels,
        average, multidim_average, top_k, ignore_index, validate_args,
    )
