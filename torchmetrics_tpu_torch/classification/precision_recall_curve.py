"""Modular multiclass PR curve (counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``).

Two state modes: ``thresholds=None`` keeps ``preds`` / ``target`` cat lists (exact
curve at compute time); ``thresholds`` given keeps a ``(T, C, 2, 2)`` sum-reduced int32
confusion tensor (binned curve, counted by kernel K2). AUROC subclasses this and
changes only ``compute``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class MulticlassPrecisionRecallCurve(Metric):
    """PR curves for multiclass tasks."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    preds: List[torch.Tensor]
    target: List[torch.Tensor]
    confmat: torch.Tensor

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args

        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._sorted_thresholds = None
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            # fixed for the metric's life: K2 takes them sorted, so sort once
            self._sorted_thresholds = sort_thresholds(self.thresholds)
            self.add_state(
                "confmat",
                default=torch.zeros((len(self.thresholds), num_classes, 2, 2), dtype=torch.int32),
                dist_reduce_fx="sum",
            )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch in the active state mode."""
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index
        )
        state = _multiclass_precision_recall_curve_update(
            preds, target, self.num_classes, self.thresholds, self._sorted_thresholds
        )
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _curve_state(self):
        return (dim_zero_cat(self.preds), dim_zero_cat(self.target)) if self.thresholds is None else self.confmat

    def compute(self):
        """Final per-class (precision, recall, thresholds)."""
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds)

    def to(self, device: Any) -> "MulticlassPrecisionRecallCurve":  # type: ignore[override]
        super().to(device)
        if self.thresholds is not None:
            self.thresholds = self.thresholds.to(self.device)
            self._sorted_thresholds = sort_thresholds(self.thresholds)
        return self
