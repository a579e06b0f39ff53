"""Modular multiclass AUROC (counterpart of ``torchmetrics_tpu/classification/auroc.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds


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

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
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
