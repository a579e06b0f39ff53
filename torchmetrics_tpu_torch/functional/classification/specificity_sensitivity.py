"""Specificity at a fixed sensitivity for binary, multiclass and multilabel tasks, and
the task router (counterpart of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``).

The states are the PR curve's (binned through kernel K2, or exact); the compute runs
the ROC compute, takes ``specificity = 1 - fpr`` in float32, and on the host, in
float64, picks the largest specificity among the points whose sensitivity clears the
floor. A tie goes to the first such point (``np.argmax``), not to the last as in the
fixed-precision metrics. ``(0.0, 1e6)`` when no point qualifies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    CurveState,
    OperatingPoint,
    _host64,
    _operating_points,
    _per_class_points,
    _validate_fixed_point_arg,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _convert_fpr_to_specificity(fpr):
    """``1 - fpr``, per tensor or per list of per-class tensors."""
    return [1 - f for f in fpr] if isinstance(fpr, list) else 1 - fpr


def _specificity_at_sensitivity(
    specificity: np.ndarray, sensitivity: np.ndarray, thresholds: np.ndarray, min_sensitivity: float
) -> OperatingPoint:
    """The largest specificity among the points whose sensitivity clears the floor (the
    first of them on a tie), and its threshold; ``(0.0, 1e6)`` when none qualifies."""
    spec, sens, thr = _host64(specificity), _host64(sensitivity), _host64(thresholds)
    n = min(len(spec), len(sens), len(thr))
    spec, sens, thr = spec[:n], sens[:n], thr[:n]
    mask = sens >= min_sensitivity
    if not mask.any():
        return 0.0, 1e6
    spec, thr = spec[mask], thr[mask]
    idx = int(np.argmax(spec))
    return float(spec[idx]), float(thr[idx])


def _binary_specificity_at_sensitivity_arg_validation(
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _validate_fixed_point_arg(min_sensitivity, "min_sensitivity")


def _binary_specificity_at_sensitivity_compute(
    state: CurveState,
    thresholds: Optional[torch.Tensor],
    min_sensitivity: float,
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    fpr, sensitivity, thresholds = _binary_roc_compute(state, thresholds, pos_label)
    point = _specificity_at_sensitivity(_convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity)
    return _operating_points(point, fpr.device)


def binary_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest specificity given a minimum sensitivity, binary task:
    ``(specificity, threshold)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_specificity_at_sensitivity
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> tuple(round(float(v), 4) for v in binary_specificity_at_sensitivity(preds, target, min_sensitivity=0.5))
        (1.0, 0.75)
    """
    if validate_args:
        _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def _multiclass_specificity_at_sensitivity_arg_validation(
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _validate_fixed_point_arg(min_sensitivity, "min_sensitivity")


def _multiclass_specificity_at_sensitivity_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    min_sensitivity: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    fpr, sensitivity, thresholds = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_class_points(
        _convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity, _specificity_at_sensitivity
    )


def multiclass_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-class specificity given a minimum sensitivity: ``(specificities, thresholds)``."""
    if validate_args:
        _multiclass_specificity_at_sensitivity_arg_validation(num_classes, min_sensitivity, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def _multilabel_specificity_at_sensitivity_arg_validation(
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _validate_fixed_point_arg(min_sensitivity, "min_sensitivity")


def _multilabel_specificity_at_sensitivity_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int],
    min_sensitivity: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    fpr, sensitivity, thresholds = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_class_points(
        _convert_fpr_to_specificity(fpr), sensitivity, thresholds, min_sensitivity, _specificity_at_sensitivity
    )


def multilabel_specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-label specificity given a minimum sensitivity: ``(specificities, thresholds)``."""
    if validate_args:
        _multilabel_specificity_at_sensitivity_arg_validation(num_labels, min_sensitivity, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index, min_sensitivity)


def specificity_at_sensitivity(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task router for specificity at a fixed sensitivity."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_specificity_at_sensitivity(
            preds, target, min_sensitivity, thresholds, ignore_index, validate_args
        ),
        lambda c: multiclass_specificity_at_sensitivity(
            preds, target, c, min_sensitivity, thresholds, ignore_index, validate_args
        ),
        lambda n: multilabel_specificity_at_sensitivity(
            preds, target, n, min_sensitivity, thresholds, ignore_index, validate_args
        ),
    )


# the reference's public name carries this typo; kept as an alias
specicity_at_sensitivity = specificity_at_sensitivity
