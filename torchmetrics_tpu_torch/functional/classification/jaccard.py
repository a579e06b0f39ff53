"""Jaccard index (IoU) for binary, multiclass and multilabel tasks, and the task
router (counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``).

The update is the confusion matrix's count; the compute reduces the matrix.

One reference quirk is copied on purpose: ``ignore_index`` may equal the number of
classes (the check is ``0 <= ignore_index <= C``). The JAX package then reads
``denom[C]``, which JAX clamps to ``denom[C - 1]``, and drops the write
``weights[C] = 0``. The port reproduces both: micro averaging subtracts the last
class's denominator, and macro keeps every class's weight.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _jaccard_index_reduce(
    confmat: torch.Tensor,
    average: Optional[str],
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Jaccard index from a ``(2, 2)``, ``(C, C)`` or ``(L, 2, 2)`` confusion matrix."""
    allowed_average = ["binary", "micro", "macro", "weighted", "none", None]
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return confmat[1, 1] / (confmat[0, 1] + confmat[1, 0] + confmat[1, 1])

    ignore_index_cond = ignore_index is not None and 0 <= ignore_index <= confmat.shape[0]
    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num

    if average == "micro":
        num = num.sum()
        # an index one past the end reads the last entry, as JAX clamps it
        denom = denom.sum() - (denom[min(ignore_index, denom.shape[0] - 1)] if ignore_index_cond else 0.0)

    jaccard = _safe_divide(num, denom)

    if average is None or average == "none" or average == "micro":
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else confmat.sum(1)
    else:
        weights = torch.ones_like(jaccard)
        # an index one past the end writes nothing, as JAX drops the update
        if ignore_index_cond and ignore_index < weights.shape[0]:
            weights[ignore_index] = 0.0
        if not multilabel:
            weights = torch.where(confmat.sum(1) + confmat.sum(0) == 0, 0.0, weights)
    return ((weights * jaccard) / weights.sum()).sum()


def binary_jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Jaccard index for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_jaccard_index
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_jaccard_index(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.5
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _jaccard_index_reduce(confmat, average="binary")


def multiclass_jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Jaccard index for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Jaccard index for multilabel tasks."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for the Jaccard index."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_jaccard_index(preds, target, threshold, ignore_index, validate_args),
        lambda c: multiclass_jaccard_index(preds, target, c, average, ignore_index, validate_args),
        lambda n: multilabel_jaccard_index(preds, target, n, threshold, average, ignore_index, validate_args),
    )
