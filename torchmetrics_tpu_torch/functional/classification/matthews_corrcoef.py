"""Matthews correlation coefficient for binary, multiclass and multilabel tasks, and
the task router (counterpart of
``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``).

The update is the confusion matrix's count. The compute reads the matrix on the host
once, as the JAX package does, and works in float64 there: the degenerate cases (only
true positives, only true negatives, a zero denominator) branch on its values. The
multilabel ``(L, 2, 2)`` matrices are summed into one ``(2, 2)`` first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _mcc_value(cm: np.ndarray) -> float:
    """MCC of a float64 confusion matrix, with the JAX package's degenerate cases."""
    if cm.size == 4:
        tn, fp, fn, tp = cm.reshape(-1)
        if tp != 0 and tn == 0 and fp == 0 and fn == 0:
            return 1.0
        if tp == 0 and tn != 0 and fp == 0 and fn == 0:
            return -1.0

    tk = cm.sum(axis=-1)
    pk = cm.sum(axis=-2)
    c = np.trace(cm)
    s = cm.sum()
    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()
    numerator = cov_ytyp
    denom = cov_ypyp * cov_ytyt

    if denom == 0 and cm.size == 4:
        a = b = 0.0
        if tp == 0 or tn == 0:
            a = tp + tn
        if fp == 0 or fn == 0:
            b = fp + fn
        eps = float(np.finfo(np.float32).eps)
        numerator = np.sqrt(eps) * (a - b)
        denom = 2 * (a + b) * (a + eps) * (b + eps)
    elif denom == 0:
        return 0.0
    return float(numerator / np.sqrt(denom))


def _matthews_corrcoef_reduce(confmat: torch.Tensor) -> torch.Tensor:
    """MCC from a ``(2, 2)``, ``(C, C)`` or ``(L, 2, 2)`` confusion matrix, as float32."""
    confmat = confmat.sum(0) if confmat.ndim == 3 else confmat
    cm = confmat.detach().to("cpu", torch.float64).numpy()
    return torch.tensor(_mcc_value(cm), dtype=torch.float32, device=confmat.device)


def binary_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """MCC for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_matthews_corrcoef
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_matthews_corrcoef(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.3333
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """MCC for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """MCC for multilabel tasks."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels)
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for the MCC."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args),
        lambda c: multiclass_matthews_corrcoef(preds, target, c, ignore_index, validate_args),
        lambda n: multilabel_matthews_corrcoef(preds, target, n, threshold, ignore_index, validate_args),
    )
