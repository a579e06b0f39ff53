"""Confusion matrices for binary, multiclass and multilabel tasks, the shared
normalization and the task router.

Counterpart of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``: the
same staged decomposition (arg validation -> tensor validation -> format -> update ->
compute).

Every update is one integer count into int32 bins through ``utilities.data._bincount``
(``target * 2 + preds`` into 4 bins, ``target * C + preds`` into ``C * C``, or
``2 * target + preds + 4 * label`` into ``4 * L``), with no float weights: the JAX
package's bf16 one-hot matmul route for the TPU has no counterpart, so the counts stay
exact at any ``N`` and any ``C``. Ignored targets become ``-1`` (multilabel: ``-4 * L``
on both sides, so the whole index is negative) and count nowhere, as does a multiclass
row whose target or prediction lies outside ``[0, C)``. With ``validate_args=False``
the updates make no device -> host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_tensor_validation,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_tensor_validation,
    _sigmoid_if_logits,
)
from torchmetrics_tpu_torch.ops.stat_counts import _argmax_nan_first
from torchmetrics_tpu_torch.utilities.checks import _is_floating
from torchmetrics_tpu_torch.utilities.data import _bincount
from torchmetrics_tpu_torch.utilities.enums import _route_task
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _confusion_matrix_reduce(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    """Normalize a confusion matrix.

    ``"true"`` divides rows (target axis), ``"pred"`` divides columns, ``"all"`` the
    whole matrix; NaNs from empty rows or columns become 0, with a warning that counts
    them (counting them reads the matrix on the host).
    """
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")
    if normalize is not None and normalize != "none":
        confmat = confmat if confmat.is_floating_point() else confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=-1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=-2, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
        nan_elements = int(torch.isnan(confmat).sum())
        if nan_elements:
            confmat = torch.nan_to_num(confmat, nan=0.0)
            rank_zero_warn(f"{nan_elements} NaN values found in confusion matrix have been replaced with zeros.")
    return confmat


def _validate_normalize(ignore_index: Optional[int], normalize: Optional[str]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Expected argument `normalize` to be one of {_ALLOWED_NORMALIZE}, but got {normalize}.")


# ------------------------------------------------------------------------------ binary


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _validate_normalize(ignore_index, normalize)


def _binary_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)


def _binary_confusion_matrix_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten, auto-sigmoid and threshold (unless ``convert_to_labels=False``);
    ignored targets become ``-1``."""
    preds = preds.flatten()
    target = target.flatten()
    if _is_floating(preds):
        preds = _sigmoid_if_logits(preds)
        if convert_to_labels:
            preds = (preds > threshold).to(torch.int32)
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _binary_confusion_matrix_update(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``(2, 2)`` int32: one count of ``target * 2 + preds`` into 4 bins."""
    unique_mapping = torch.where(target < 0, -1, target.long() * 2 + preds.long())
    return _bincount(unique_mapping, minlength=4).reshape(2, 2)


def _binary_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """``(2, 2)`` confusion matrix for binary tasks: rows are targets, columns predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_confusion_matrix
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> binary_confusion_matrix(preds, torch.tensor([1, 0, 1, 1, 0, 0])).tolist()
        [[2, 1], [1, 2]]
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _binary_confusion_matrix_compute(confmat, normalize)


# --------------------------------------------------------------------------- multiclass


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _validate_normalize(ignore_index, normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Shape and value checks; counting unique values is a device -> host sync."""
    _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)


def _multiclass_confusion_matrix_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax logits (first index wins a tie, NaN is maximal: K1's rule) and flatten;
    ignored targets become ``-1``. ``convert_to_labels=False`` keeps the scores as
    ``(samples, C)`` rows (hinge loss, calibration error)."""
    if convert_to_labels:
        if preds.ndim == target.ndim + 1:
            preds = _argmax_nan_first(preds)
        preds = preds.flatten()
    else:
        preds = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
    target = target.flatten()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_confusion_matrix_update(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, rows: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """``confmat[i, j] = #{n : target[n] == i, preds[n] == j}``, int32 ``(C, C)``.

    Out-of-range predictions and targets are dropped: without the bound on ``preds``
    an invalid code would alias into a wrong cell of the flattened count. ``rows =
    (lo, hi)`` counts only the target rows of a shard (``parallel/sharding.py``): a
    target outside them goes to the drop bin, the index is rebased to ``(target - lo)
    * C + pred`` and the result is ``(hi - lo, C)``.
    """
    lo, hi = (0, num_classes) if rows is None else rows
    invalid = (target < lo) | (target >= hi) | (preds < 0) | (preds >= num_classes)
    unique_mapping = torch.where(invalid, -1, (target.long() - lo) * num_classes + preds.long())
    return _bincount(unique_mapping, minlength=(hi - lo) * num_classes).reshape(hi - lo, num_classes)


def _multiclass_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """``(C, C)`` confusion matrix: rows are targets, columns predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import multiclass_confusion_matrix
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> preds = torch.tensor([2, 1, 0, 1])
        >>> multiclass_confusion_matrix(preds, target, num_classes=3)
        tensor([[1, 1, 0],
                [0, 1, 0],
                [0, 0, 1]], dtype=torch.int32)
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# --------------------------------------------------------------------------- multilabel


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    _validate_normalize(ignore_index, normalize)


def _multilabel_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _multilabel_stat_scores_tensor_validation(preds, target, num_labels, "global", ignore_index)


def _multilabel_confusion_matrix_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    should_threshold: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """To ``(samples, L)``: auto-sigmoid and threshold; ignored elements become
    ``-4 * L`` on both sides, so their bin index stays negative."""
    if _is_floating(preds):
        preds = _sigmoid_if_logits(preds)
        if should_threshold:
            preds = (preds > threshold).to(torch.int32)
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    if ignore_index is not None:
        idx = target == ignore_index
        sentinel = -4 * num_labels
        preds = torch.where(idx, sentinel, preds)
        target = torch.where(idx, sentinel, target)
    return preds, target


def _multilabel_confusion_matrix_update(preds: torch.Tensor, target: torch.Tensor, num_labels: int) -> torch.Tensor:
    """``(L, 2, 2)`` int32: one count of ``2 * target + preds + 4 * label`` into ``4 * L`` bins."""
    offsets = 4 * torch.arange(num_labels, device=preds.device)
    unique_mapping = ((2 * target.long() + preds.long()) + offsets).flatten()
    return _bincount(unique_mapping, minlength=4 * num_labels).reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """``(L, 2, 2)`` confusion matrices, one per label."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for the confusion matrix."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args),
        lambda c: multiclass_confusion_matrix(preds, target, c, normalize, ignore_index, validate_args),
        lambda n: multilabel_confusion_matrix(preds, target, n, threshold, normalize, ignore_index, validate_args),
    )
