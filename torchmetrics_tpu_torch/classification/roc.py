"""Modular ROC curves for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/roc.py``): the PR-curve metrics
with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class BinaryROC(BinaryPrecisionRecallCurve):
    """ROC for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryROC
        >>> metric = BinaryROC(thresholds=5, device="cpu")
        >>> metric.update(torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65]), torch.tensor([1, 0, 1, 1, 0, 0]))
        >>> [tuple(v.shape) for v in metric.compute()]
        [(5,), (5,), (5,)]
    """

    def compute(self):
        """(fpr, tpr, thresholds)."""
        return _binary_roc_compute(self._curve_state(), self.thresholds)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """ROC for multiclass tasks."""

    def compute(self):
        """Per-class (fpr, tpr, thresholds)."""
        return _multiclass_roc_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """ROC for multilabel tasks."""

    def compute(self):
        """Per-label (fpr, tpr, thresholds)."""
        return _multilabel_roc_compute(self._curve_state(), self.num_labels, self.thresholds, self.ignore_index)


class ROC:
    """Task router: ``ROC(task=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryROC(**kwargs),
            lambda c: MulticlassROC(c, **kwargs),
            lambda n: MultilabelROC(n, **kwargs),
        )
