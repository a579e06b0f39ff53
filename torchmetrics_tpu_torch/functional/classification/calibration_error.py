"""Expected calibration error for binary and multiclass tasks, and the task router
(counterpart of ``torchmetrics_tpu/functional/classification/calibration_error.py``).

The states are the raw (confidence, accuracy) streams; binning happens at compute.
The bin edges are ``jnp.linspace(0, 1, n_bins + 1)``'s float32 values bit for bit
(``_adjust_threshold_arg``), and a confidence's bin is ``searchsorted(edges, c,
right=True) - 1``, so there are ``n_bins + 1`` bins and a confidence of exactly 1.0
lands in the last one, as in the JAX package. The per-bin sums are float32
``index_add_``s: on the card their order is the atomics', so a bin's sum may differ
from the CPU's in its low bits. Dropping the rows whose target is ignored stays a host
read, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _multiclass_confusion_matrix_format,
)
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_tensor_validation,
    _drop_ignored_rows,
    _multiclass_hinge_loss_tensor_validation,
    _softmax_if_logits,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from torchmetrics_tpu_torch.ops.stat_counts import _argmax_nan_first
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task

_NORMS = ("l1", "l2", "max")

# the tensor checks are the hinge loss's: the confusion-matrix checks and floating preds
_binary_calibration_error_tensor_validation = _binary_hinge_loss_tensor_validation
_multiclass_calibration_error_tensor_validation = _multiclass_hinge_loss_tensor_validation


def _binning_bucketize(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin accuracy, confidence and proportion, from three scatter-adds."""
    accuracies = accuracies.to(confidences.dtype)
    n_bins = bin_boundaries.shape[0]
    indices = torch.searchsorted(bin_boundaries, confidences, right=True) - 1

    def per_bin(values: torch.Tensor) -> torch.Tensor:
        return torch.zeros(n_bins, dtype=confidences.dtype, device=confidences.device).index_add_(0, indices, values)

    count_bin = per_bin(torch.ones_like(confidences))
    conf_bin = torch.nan_to_num(per_bin(confidences) / count_bin)
    acc_bin = torch.nan_to_num(per_bin(accuracies) / count_bin)
    # no observed sample: every proportion is the documented zero, not 0/0
    prop_bin = _safe_divide(count_bin, count_bin.sum())
    return acc_bin, conf_bin, prop_bin


def _ce_compute(
    confidences: torch.Tensor,
    accuracies: torch.Tensor,
    bin_boundaries: Union[torch.Tensor, int],
    norm: str = "l1",
    debias: bool = False,
) -> torch.Tensor:
    """Calibration error under the l1, l2 or max norm."""
    if isinstance(bin_boundaries, int):
        bin_boundaries = _adjust_threshold_arg(bin_boundaries + 1, confidences.device)
    if norm not in _NORMS:
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
    if norm == "l1":
        return ((acc_bin - conf_bin).abs() * prop_bin).sum()
    if norm == "max":
        return (acc_bin - conf_bin).abs().max()
    ce = ((acc_bin - conf_bin) ** 2 * prop_bin).sum()
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * confidences.shape[0] - 1)
        ce = ce + torch.nan_to_num(debias_bins).sum()
    return torch.where(ce > 0, torch.sqrt(torch.clamp(ce, min=0.0)), 0.0)


def _binary_calibration_error_arg_validation(
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    if norm not in _NORMS:
        raise ValueError(f"Expected argument `norm` to be one of ('l1', 'l2', 'max'), but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confidence is the probability of the positive class, accuracy the target."""
    return preds.to(torch.float32), target.to(torch.float32)


def _binary_calibration_error_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _binary_confusion_matrix_format(
        preds, target, threshold=0.0, ignore_index=ignore_index, convert_to_labels=False
    )
    return _drop_ignored_rows(preds, target)


def binary_calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Expected calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_calibration_error
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> round(float(binary_calibration_error(preds, target)), 4)
        0.3167
    """
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_calibration_error_format(preds, target, ignore_index)
    confidences, accuracies = _binary_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int,
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_format(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    return _drop_ignored_rows(preds, target)


def _multiclass_calibration_error_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 confidence and its correctness (the argmax is K1's rule)."""
    preds = _softmax_if_logits(preds)
    confidences = preds.max(dim=1).values
    accuracies = (_argmax_nan_first(preds) == target).to(torch.float32)
    return confidences.to(torch.float32), accuracies


def multiclass_calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Top-label expected calibration error for multiclass tasks."""
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_calibration_error_format(preds, target, ignore_index)
    confidences, accuracies = _multiclass_calibration_error_update(preds, target)
    return _ce_compute(confidences, accuracies, n_bins, norm)


def calibration_error(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router: ``task="binary"`` or ``"multiclass"``."""
    return _route_task(
        task, num_classes, None,
        lambda: binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args),
        lambda c: multiclass_calibration_error(preds, target, c, n_bins, norm, ignore_index, validate_args),
        None,
        tasks=ClassificationTaskNoMultilabel,
    )
