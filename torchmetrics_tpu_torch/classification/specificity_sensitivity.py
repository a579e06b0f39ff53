"""Modular specificity at a fixed sensitivity for binary, multiclass and multilabel
tasks, and the task router (counterpart of
``torchmetrics_tpu/classification/specificity_sensitivity.py``): the PR curves with
the ROC-based operating point as ``compute``."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import (
    _binary_specificity_at_sensitivity_arg_validation,
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_arg_validation,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_arg_validation,
    _multilabel_specificity_at_sensitivity_compute,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """Highest specificity at a minimum sensitivity, binary task: ``(specificity, threshold)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificityAtSensitivity
        >>> metric = BinarySpecificityAtSensitivity(min_sensitivity=0.5, device="cpu")
        >>> metric.update(torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65]), torch.tensor([1, 0, 1, 1, 0, 0]))
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 0.75)
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False

    def __init__(
        self,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds, ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_specificity_at_sensitivity_arg_validation(min_sensitivity, thresholds, ignore_index)
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(highest specificity, its threshold)."""
        return _binary_specificity_at_sensitivity_compute(self._curve_state(), self.thresholds, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Per-class highest specificity at a minimum sensitivity: ``(specificities, thresholds)``."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_legend_name: str = "Class"

    def __init__(
        self,
        num_classes: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_specificity_at_sensitivity_arg_validation(
                num_classes, min_sensitivity, thresholds, ignore_index
            )
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(per-class highest specificity, per-class thresholds)."""
        return _multiclass_specificity_at_sensitivity_compute(
            self._curve_state(), self.num_classes, self.thresholds, self.min_sensitivity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Per-label highest specificity at a minimum sensitivity: ``(specificities, thresholds)``."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_specificity_at_sensitivity_arg_validation(
                num_labels, min_sensitivity, thresholds, ignore_index
            )
        self.validate_args = validate_args
        self.min_sensitivity = min_sensitivity

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """(per-label highest specificity, per-label thresholds)."""
        return _multilabel_specificity_at_sensitivity_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index, self.min_sensitivity
        )


class SpecificityAtSensitivity:
    """Task router: returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        min_sensitivity: float,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinarySpecificityAtSensitivity(min_sensitivity, thresholds, ignore_index, validate_args, **kwargs),
            lambda c: MulticlassSpecificityAtSensitivity(
                c, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            ),
            lambda n: MultilabelSpecificityAtSensitivity(
                n, min_sensitivity, thresholds, ignore_index, validate_args, **kwargs
            ),
        )
