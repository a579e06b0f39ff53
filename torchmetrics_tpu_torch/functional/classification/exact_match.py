"""Exact match for multiclass and multilabel tasks, and the task router (counterpart
of ``torchmetrics_tpu/functional/classification/exact_match.py``).

A sample matches when every one of its positions does: the multidim positions of a
multiclass ``(N, C, ...)`` / ``(N, ...)`` input, or the labels (and extra positions)
of a multilabel one. Ignored positions count as matching, in both tasks. There is no
binary task. The counts are int32; ``total`` is made on the device from the batch
shape (no host tensor), so the global update can run in a captured graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary, _route_task


def _exact_match_reduce(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return _safe_divide(correct, total)


def _count(value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=like.device)


def _multiclass_exact_match_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(correct, total)`` from ``(N, X)`` labels; ignored positions match."""
    if ignore_index is not None:
        preds = torch.where(target == ignore_index, ignore_index, preds)
    correct = (preds == target).sum(dim=1) == preds.shape[1]
    correct = correct if multidim_average == "samplewise" else correct.sum()
    total = _count(preds.shape[0] if multidim_average == "global" else 1, preds)
    return correct.to(torch.int32), total


def multiclass_exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Exact match for multidim multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_exact_match
        >>> target = torch.tensor([[[0, 1], [2, 1], [0, 2]], [[1, 1], [2, 0], [1, 2]]])
        >>> preds = torch.tensor([[[0, 1], [2, 1], [0, 2]], [[2, 2], [2, 1], [1, 0]]])
        >>> float(multiclass_exact_match(preds, target, num_classes=3))
        0.5
    """
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, multidim_average: str = "global"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(correct, total)`` from ``(N, L, X)`` labels: per sample (and position, when
    global) all ``L`` labels must match."""
    if multidim_average == "global":
        preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
        target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    correct = ((preds == target).sum(dim=1) == num_labels).sum(dim=-1)
    total = _count(preds.shape[0 if multidim_average == "global" else 2], preds)
    return correct.to(torch.int32), total


def _multilabel_exact_match_format(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, threshold: float, ignore_index: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stat-scores format, then ignored positions (target ``-1``) made to match."""
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    if ignore_index is not None:
        preds = torch.where(target == -1, -1, preds)
    return preds, target


def multilabel_exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Exact match for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_exact_match_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for exact match (multiclass or multilabel)."""
    return _route_task(
        task, num_classes, num_labels,
        None,
        lambda c: multiclass_exact_match(preds, target, c, multidim_average, ignore_index, validate_args),
        lambda n: multilabel_exact_match(
            preds, target, n, threshold, multidim_average, ignore_index, validate_args
        ),
        tasks=ClassificationTaskNoBinary,
    )
