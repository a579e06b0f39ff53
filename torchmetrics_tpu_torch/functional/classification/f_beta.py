"""F-beta and F1 for binary, multiclass and multilabel tasks, and their task routers
(counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``).

A reduce of the stat-scores counters: ``(1 + b^2) tp / ((1 + b^2) tp + b^2 fn + fp)``.
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


def _fbeta_reduce(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
) -> torch.Tensor:
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    if average == "micro":
        axis = 0 if multidim_average == "global" else 1
        tp = _sum_axis(tp, axis)
        fn = _sum_axis(fn, axis)
        fp = _sum_axis(fp, axis)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F-beta for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_fbeta_score
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_fbeta_score(preds, torch.tensor([1, 0, 1, 1, 0, 0]), beta=1.0)), 4)
        0.6667
    """
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = _binary_stat_scores_pipeline(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average="binary", multidim_average=multidim_average)


def multiclass_fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F-beta for multiclass tasks."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = _multiclass_stat_scores_pipeline(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average)


def multilabel_fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F-beta for multilabel tasks."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = _multilabel_stat_scores_pipeline(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _fbeta_reduce(tp, fp, tn, fn, beta, average=average, multidim_average=multidim_average, multilabel=True)


def binary_f1_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F1 for binary tasks."""
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


def multiclass_f1_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F1 for multiclass tasks."""
    return multiclass_fbeta_score(
        preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )


def multilabel_f1_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """F1 for multilabel tasks."""
    return multilabel_fbeta_score(
        preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )


def fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    beta: float = 1.0,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for F-beta."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args),
        lambda c: multiclass_fbeta_score(
            preds, target, beta, c, average, top_k, multidim_average, ignore_index, validate_args
        ),
        lambda n: multilabel_fbeta_score(
            preds, target, beta, n, threshold, average, multidim_average, ignore_index, validate_args
        ),
    )


def f1_score(
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
    """Task router for F1."""
    return fbeta_score(
        preds, target, task, 1.0, threshold, num_classes, num_labels,
        average, multidim_average, top_k, ignore_index, validate_args,
    )
