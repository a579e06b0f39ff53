"""Modular AUROC for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/auroc.py``): the PR-curve metrics
with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """AUROC for binary tasks; ``max_fpr`` gives the McClish-corrected partial area.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
        >>> metric = BinaryAUROC(device="cpu")
        >>> float(metric(torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34]), torch.tensor([0, 0, 1, 1, 1])))
        0.5
    """

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.validate_args = validate_args
        self.max_fpr = max_fpr

    def compute(self) -> torch.Tensor:
        """Area under the ROC curve."""
        return _binary_auroc_compute(self._curve_state(), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """AUROC for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, thresholds=5, device="cpu")
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6], [0.5, 0.3, 0.2]])
        >>> round(float(metric(preds, torch.tensor([0, 1, 2, 1]))), 4)
        0.9444
    """

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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> torch.Tensor:
        """Averaged per-class AUROC."""
        return _multiclass_auroc_compute(self._curve_state(), self.num_classes, self.average, self.thresholds)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """AUROC for multilabel tasks (``average`` in micro, macro, weighted, none)."""

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
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.validate_args = validate_args
        self.average = average

    def compute(self) -> torch.Tensor:
        """Averaged per-label AUROC."""
        return _multilabel_auroc_compute(
            self._curve_state(), self.num_labels, self.average, self.thresholds, self.ignore_index
        )


class AUROC:
    """Task router: ``AUROC(task=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryAUROC(max_fpr, **kwargs),
            lambda c: MulticlassAUROC(c, average, **kwargs),
            lambda n: MultilabelAUROC(n, average, **kwargs),
        )
