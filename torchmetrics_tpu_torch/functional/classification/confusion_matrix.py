"""Multiclass confusion matrix and the shared normalization.

Counterpart of the multiclass part of
``torchmetrics_tpu/functional/classification/confusion_matrix.py``: the same staged
decomposition (arg validation -> tensor validation -> format -> update -> compute).

The update is one integer count of ``target * C + preds`` into ``C * C`` int32 bins
through ``utilities.data._bincount``, with no float weights: the JAX package's bf16
one-hot matmul route for the TPU has no counterpart, so the counts stay exact at any
``N`` and any ``C``. Ignored targets become ``-1``; a row whose target or prediction
lies outside ``[0, C)`` counts nowhere. With ``validate_args=False`` the update makes
no device -> host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _multiclass_stat_scores_tensor_validation
from torchmetrics_tpu_torch.ops.stat_counts import _argmax_nan_first
from torchmetrics_tpu_torch.utilities.data import _bincount
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


def _bincount_2d(mapping: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Int32 count of ``mapping`` into ``n_bins``; negative and out-of-range indices are
    dropped. Unweighted: every kept row counts one, so no weights are built."""
    return _bincount(mapping, minlength=n_bins)


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Expected argument `normalize` to be one of {_ALLOWED_NORMALIZE}, but got {normalize}.")


def _multiclass_confusion_matrix_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Shape and value checks; counting unique values is a device -> host sync."""
    _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)


def _multiclass_confusion_matrix_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax logits (first index wins a tie, NaN is maximal: K1's rule) and flatten;
    ignored targets become ``-1``."""
    if preds.ndim == target.ndim + 1:
        preds = _argmax_nan_first(preds)
    preds = preds.flatten()
    target = target.flatten()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    return preds, target


def _multiclass_confusion_matrix_update(preds: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``confmat[i, j] = #{n : target[n] == i, preds[n] == j}``, int32 ``(C, C)``.

    Out-of-range predictions and targets are dropped: without the bound on ``preds``
    an invalid code would alias into a wrong cell of the flattened count.
    """
    invalid = (target < 0) | (target >= num_classes) | (preds < 0) | (preds >= num_classes)
    unique_mapping = torch.where(invalid, -1, target.long() * num_classes + preds.long())
    return _bincount_2d(unique_mapping, num_classes * num_classes).reshape(num_classes, num_classes)


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
