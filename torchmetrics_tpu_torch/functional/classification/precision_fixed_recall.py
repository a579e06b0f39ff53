"""Precision at a fixed recall for binary, multiclass and multilabel tasks, and the
task router (counterpart of
``torchmetrics_tpu/functional/classification/precision_fixed_recall.py``).

The mirror of ``recall_fixed_precision.py``: the same curve states and the same host
reduction, with the objective and the constrained coordinate swapped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    OperatingPoint,
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _lexi_max_at_constraint,
    _multiclass_recall_at_fixed_precision_arg_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_arg_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
)
from torchmetrics_tpu_torch.utilities.enums import _route_task


def _precision_at_recall(
    precision: np.ndarray, recall: np.ndarray, thresholds: np.ndarray, min_recall: float
) -> OperatingPoint:
    """Highest precision whose recall clears the floor."""
    return _lexi_max_at_constraint(precision, recall, thresholds, min_recall)


def binary_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest precision given a minimum recall, binary task: ``(precision, threshold)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision_at_fixed_recall
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> tuple(round(float(v), 4) for v in binary_precision_at_fixed_recall(preds, target, min_recall=0.5))
        (1.0, 0.75)
    """
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index, arg_name="min_recall")
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_recall, reduce_fn=_precision_at_recall)


def multiclass_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-class precision given a minimum recall: ``(precisions, thresholds)``."""
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(
            num_classes, min_recall, thresholds, ignore_index, arg_name="min_recall"
        )
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_recall_at_fixed_precision_arg_compute(
        state, num_classes, thresholds, min_recall, reduce_fn=_precision_at_recall
    )


def multilabel_precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-label precision given a minimum recall: ``(precisions, thresholds)``."""
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(
            num_labels, min_recall, thresholds, ignore_index, arg_name="min_recall"
        )
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_recall_at_fixed_precision_arg_compute(
        state, num_labels, thresholds, ignore_index, min_recall, reduce_fn=_precision_at_recall
    )


def precision_at_fixed_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_recall: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task router for precision at a fixed recall."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_precision_at_fixed_recall(preds, target, min_recall, thresholds, ignore_index, validate_args),
        lambda c: multiclass_precision_at_fixed_recall(
            preds, target, c, min_recall, thresholds, ignore_index, validate_args
        ),
        lambda n: multilabel_precision_at_fixed_recall(
            preds, target, n, min_recall, thresholds, ignore_index, validate_args
        ),
    )
