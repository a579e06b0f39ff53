"""Modular recall at a fixed precision for binary, multiclass and multilabel tasks,
and the task router (counterpart of
``torchmetrics_tpu/classification/recall_fixed_precision.py``).

Each class is its PR curve with another ``compute``: the same states (kernel K2's
binned confusion tensor, or exact score lists), so in a collection a binned one
merges with the other binned curves over the same thresholds, and under the engine it
runs eagerly, counted, as the binned curves do (their range check reads the host).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _multiclass_recall_at_fixed_precision_arg_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_arg_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Highest recall at a minimum precision, binary task: ``(recall, threshold)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryRecallAtFixedPrecision
        >>> metric = BinaryRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> metric.update(torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65]), torch.tensor([1, 0, 1, 1, 0, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.35)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds, ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(highest recall, its threshold)."""
        return _binary_recall_at_fixed_precision_compute(self._curve_state(), self.thresholds, self.min_precision)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Per-class highest recall at a minimum precision: ``(recalls, thresholds)``."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_legend_name: str = "Class"

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(per-class highest recall, per-class thresholds)."""
        return _multiclass_recall_at_fixed_precision_arg_compute(
            self._curve_state(), self.num_classes, self.thresholds, self.min_precision
        )


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Per-label highest recall at a minimum precision: ``(recalls, thresholds)``."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        min_precision: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(per-label highest recall, per-label thresholds)."""
        return _multilabel_recall_at_fixed_precision_arg_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_precision
        )


class RecallAtFixedPrecision:
    """Task router: returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_precision: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryRecallAtFixedPrecision(min_precision, thresholds, ignore_index, validate_args, **kwargs),
            lambda c: MulticlassRecallAtFixedPrecision(
                c, min_precision, thresholds, ignore_index, validate_args, **kwargs
            ),
            lambda n: MultilabelRecallAtFixedPrecision(
                n, min_precision, thresholds, ignore_index, validate_args, **kwargs
            ),
        )
