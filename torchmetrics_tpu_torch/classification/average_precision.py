"""Modular average precision for binary, multiclass and multilabel tasks, and the task
router (counterpart of ``torchmetrics_tpu/classification/average_precision.py``): the
PR-curve metrics with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_arg_validation,
    _multilabel_average_precision_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """AP for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAveragePrecision
        >>> metric = BinaryAveragePrecision(device="cpu")
        >>> round(float(metric(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))), 4)
        0.8333
    """

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        """Area under the PR curve."""
        return _binary_average_precision_compute(self._curve_state(), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """AP for multiclass tasks."""

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> torch.Tensor:
        """Averaged per-class AP."""
        return _multiclass_average_precision_compute(
            self._curve_state(), self.num_classes, self.average, self.thresholds
        )


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """AP for multilabel tasks (``average="macro"``: the mAP of multilabel image classification)."""

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> torch.Tensor:
        """Averaged per-label AP."""
        return _multilabel_average_precision_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AveragePrecision:
    """Task router: ``AveragePrecision(task=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryAveragePrecision(**kwargs),
            lambda c: MulticlassAveragePrecision(c, average, **kwargs),
            lambda n: MultilabelAveragePrecision(n, average, **kwargs),
        )
