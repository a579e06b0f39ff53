"""Hamming distance for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/functional/classification/hamming.py``).

A reduce of the stat-scores counters: one minus an accuracy-style score. The
multiclass variant runs kernel K1 where its gate admits the inputs.
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


def _hamming_distance_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    """``1 - (tp + tn) / all`` (binary and multilabel) or ``1 - tp / (tp + fn)``
    (multiclass), averaged as ``average`` says."""
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp = _sum_axis(tp, axis)
        fn = _sum_axis(fn, axis)
        if multilabel:
            fp = _sum_axis(fp, axis)
            tn = _sum_axis(tn, axis)
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = 1 - _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else 1 - _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn)


def binary_hamming_distance(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Hamming distance for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hamming_distance
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_hamming_distance(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.3333
    """
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_hamming_distance(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Hamming distance for multiclass tasks."""
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _hamming_distance_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average)


def multilabel_hamming_distance(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Hamming distance for multilabel tasks."""
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _hamming_distance_reduce(
        tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True
    )


def hamming_distance(
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
    """Task router: ``binary_hamming_distance``, ``multiclass_hamming_distance`` or
    ``multilabel_hamming_distance``."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_hamming_distance(preds, target, threshold, multidim_average, ignore_index, validate_args),
        lambda c: multiclass_hamming_distance(
            preds, target, c, average, top_k, multidim_average, ignore_index, validate_args
        ),
        lambda n: multilabel_hamming_distance(
            preds, target, n, threshold, average, multidim_average, ignore_index, validate_args
        ),
    )
