"""Cohen's kappa for binary and multiclass tasks, and the task router (counterpart of
``torchmetrics_tpu/functional/classification/cohen_kappa.py``).

The update is the confusion matrix's count; the compute reduces the matrix in
float32. The expected matrix is the outer product of the marginals, written as a
broadcast multiply (one product per cell, as XLA's ``(C, 1) @ (1, C)`` gives). The
weighted sums over the ``C * C`` cells add in another order than XLA's, so the value
agrees with the JAX package to a relative tolerance, not bit for bit.
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
)
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task


def _cohen_kappa_reduce(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """Kappa from a ``(C, C)`` confusion matrix; ``weights``: None, linear or quadratic."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 * sum0 / sum0.sum()

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[:, None] - idx[None, :]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = (w_mat * confmat).sum() / (w_mat * expected).sum()
    return 1 - k


def _validate_weights(weights: Optional[str]) -> None:
    if weights not in (None, "none", "linear", "quadratic"):
        raise ValueError(
            f"Expected argument `weights` to be one of None, 'none', 'linear' or 'quadratic' but got {weights}"
        )


def binary_cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Cohen's kappa for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_cohen_kappa
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(binary_cohen_kappa(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.3333
    """
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _validate_weights(weights)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Cohen's kappa for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _validate_weights(weights)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes)
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    weights: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for Cohen's kappa (binary or multiclass)."""
    return _route_task(
        task, num_classes, None,
        lambda: binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args),
        lambda c: multiclass_cohen_kappa(preds, target, c, weights, ignore_index, validate_args),
        None,
        tasks=ClassificationTaskNoMultilabel,
    )
