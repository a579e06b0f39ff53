"""Hinge loss for binary and multiclass tasks, and the task router (counterpart of
``torchmetrics_tpu/functional/classification/hinge.py``).

A running sum of the per-sample measures and an int32 count. The margins are
``torch.where`` selects and the multiclass one-hot is ``to_onehot``'s comparison, so
the update itself reads nothing back to the host; the test whether the scores are
already probabilities is made on the device as well (``_softmax_if_logits``, where the
JAX package reads it on the host: the values are the same). Dropping the rows whose
target is ignored changes a shape: it stays a host read, as in the JAX package, so
under the engine these updates run eagerly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.checks import _is_floating
from torchmetrics_tpu_torch.utilities.data import to_onehot
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task


def _hinge_loss_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def _drop_ignored_rows(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the rows whose target is not negative (ignored targets are ``-1``): a host
    read, and a boolean index only when a row is dropped."""
    keep = target >= 0
    if not bool(keep.all()):
        preds, target = preds[keep], target[keep]
    return preds, target


def _softmax_if_logits(preds: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis unless every score lies in [0, 1]: chosen on the
    device, never read back."""
    is_probs = ((preds >= 0) & (preds <= 1)).all()
    return torch.where(is_probs, preds, torch.softmax(preds, dim=1))


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    if not _is_floating(preds):
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _count(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=like.device)


def _binary_hinge_loss_update(
    preds: torch.Tensor, target: torch.Tensor, squared: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    margin = torch.where(target == 1, preds, -preds)
    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2
    return measures.sum(dim=0), _count(target.shape[0], target)


def binary_hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> torch.Tensor:
    """Hinge loss for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_hinge_loss
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> round(float(binary_hinge_loss(preds, target)), 4)
        0.8167
    """
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.0, ignore_index=ignore_index, convert_to_labels=False
    )
    preds, target = _drop_ignored_rows(preds, target)
    measures, total = _binary_hinge_loss_update(preds, target, squared)
    return _hinge_loss_compute(measures, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all') but got {multiclass_mode}"
        )


def _multiclass_hinge_loss_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    if not _is_floating(preds):
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )


def _multiclass_hinge_loss_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool,
    multiclass_mode: str = "crammer-singer",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crammer-Singer: one measure per sample from the true class's score against the
    best other one (a masked max); one-vs-all: one per sample and class."""
    preds = _softmax_if_logits(preds)
    target_oh = to_onehot(target, max(2, preds.shape[1])).bool()
    if multiclass_mode == "crammer-singer":
        true_score = torch.where(target_oh, preds, 0.0).sum(dim=1)
        best_other = torch.where(target_oh, -torch.inf, preds).max(dim=1).values
        margin = true_score - best_other
    else:
        margin = torch.where(target_oh, preds, -preds)
    measures = torch.clamp(1 - margin, min=0)
    if squared:
        measures = measures**2
    return measures.sum(dim=0), _count(target.shape[0], target)


def multiclass_hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = False,
) -> torch.Tensor:
    """Hinge loss for multiclass tasks (per class in ``one-vs-all`` mode)."""
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    preds, target = _drop_ignored_rows(preds, target)
    measures, total = _multiclass_hinge_loss_update(preds, target, squared, multiclass_mode)
    return _hinge_loss_compute(measures, total)


def hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router: ``task="binary"`` or ``"multiclass"``."""
    return _route_task(
        task, num_classes, None,
        lambda: binary_hinge_loss(preds, target, squared, ignore_index, validate_args),
        lambda c: multiclass_hinge_loss(preds, target, c, squared, multiclass_mode, ignore_index, validate_args),
        None,
        tasks=ClassificationTaskNoMultilabel,
    )
