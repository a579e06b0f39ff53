"""Multilabel ranking metrics: coverage error, label-ranking average precision and
label-ranking loss (counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``).

Every update is row-wise tensor work with no host read: ranks are a row-wise
``torch.sort`` and a 2-D ``torch.searchsorted`` (the max rank among ties, as the JAX
package's per-row ``vmap`` gives), and the ranking loss's inverse permutation is two
stable argsorts, as ``jnp.argsort`` sorts. The coverage offset uses the batch's global
``preds.min()``, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.checks import _is_floating
from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _rank_data(x: torch.Tensor) -> torch.Tensor:
    """Each value's max rank among ties, along the last axis (1-based)."""
    return torch.searchsorted(torch.sort(x, dim=-1).values, x, right=True)


def _ranking_reduce(score: torch.Tensor, n_elements: torch.Tensor) -> torch.Tensor:
    """Mean over samples; zero samples give the documented zero, not 0/0."""
    return _safe_divide(score, n_elements)


def _multilabel_ranking_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    if not _is_floating(preds):
        raise ValueError(f"Expected preds tensor to be floating point, but received input with dtype {preds.dtype}")


def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=like.device)


def _multilabel_coverage_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    offset = torch.where(target == 0, preds.min().abs() + 10, 0.0)
    preds_min = (preds + offset).min(dim=1).values
    coverage = (preds >= preds_min[:, None]).sum(dim=1).to(torch.float32)
    return coverage.sum(), _count(coverage.numel(), preds)


def _multilabel_ranking_average_precision_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each sample and relevant label j: (rank of j among the relevant scores) /
    (rank of j among all scores), averaged over the relevant labels; a sample with no
    relevant label, or with every label relevant, scores 1."""
    neg_preds = -preds
    n_labels = neg_preds.shape[1]
    relevant = target == 1
    rank_all = _rank_data(neg_preds).to(torch.float32)
    # rank among the relevant labels only: relevant entries with a value <= the score
    sorted_rel = torch.sort(torch.where(relevant, neg_preds, torch.inf), dim=1).values
    rank_rel = torch.searchsorted(sorted_rel, neg_preds, right=True).to(torch.float32)
    ratio = torch.where(relevant, rank_rel / rank_all, 0.0)
    k = relevant.sum(dim=1)
    mean_ratio = torch.where(k > 0, ratio.sum(dim=1) / torch.clamp(k, min=1), 1.0)
    scores = torch.where((k > 0) & (k < n_labels), mean_ratio, 1.0)
    return scores.sum(), _count(neg_preds.shape[0], preds)


def _multilabel_ranking_loss_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n_preds, n_labels = preds.shape
    relevant = target == 1
    n_relevant = relevant.sum(dim=1)
    mask = (n_relevant > 0) & (n_relevant < n_labels)
    inverse = torch.argsort(torch.argsort(preds, dim=1, stable=True), dim=1, stable=True)
    per_label_loss = ((n_labels - inverse) * relevant).to(torch.float32)
    correction = 0.5 * n_relevant * (n_relevant + 1)
    denom = n_relevant * (n_labels - n_relevant)
    loss = (per_label_loss.sum(dim=1) - correction) / torch.clamp(denom, min=1)
    loss = torch.where(mask, loss, 0.0)
    return loss.sum(), _count(n_preds, preds)


def _ranking_format(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int], validate_args: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    return _multilabel_confusion_matrix_format(
        preds, target, num_labels, threshold=0.0, ignore_index=ignore_index, should_threshold=False
    )


def multilabel_coverage_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Coverage error: how far down the ranking one must go to cover every true label.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multilabel_coverage_error
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(multilabel_coverage_error(preds, target, num_labels=3)), 4)
        1.6667
    """
    preds, target = _ranking_format(preds, target, num_labels, ignore_index, validate_args)
    return _ranking_reduce(*_multilabel_coverage_error_update(preds, target))


def multilabel_ranking_average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Label-ranking average precision."""
    preds, target = _ranking_format(preds, target, num_labels, ignore_index, validate_args)
    return _ranking_reduce(*_multilabel_ranking_average_precision_update(preds, target))


def multilabel_ranking_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Label-ranking loss: the share of wrongly ordered (relevant, irrelevant) pairs."""
    preds, target = _ranking_format(preds, target, num_labels, ignore_index, validate_args)
    return _ranking_reduce(*_multilabel_ranking_loss_update(preds, target))
