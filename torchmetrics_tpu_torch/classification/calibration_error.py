"""Modular expected calibration error for binary and multiclass tasks, and the task
router (counterpart of ``torchmetrics_tpu/classification/calibration_error.py``).

The states are cat lists of float32 confidences and accuracies; binning happens at
compute. The list states make the engine run every update eagerly, counted, as the
JAX engine does. Every update reads the host once to drop ignored rows.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_format,
    _binary_calibration_error_tensor_validation,
    _binary_calibration_error_update,
    _ce_compute,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_format,
    _multiclass_calibration_error_tensor_validation,
    _multiclass_calibration_error_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task


class _AbstractCalibrationError(Metric):
    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _create_state(self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool) -> None:
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("confidences", [], dist_reduce_fx="cat")
        self.add_state("accuracies", [], dist_reduce_fx="cat")

    def _update_state(self, confidences: torch.Tensor, accuracies: torch.Tensor) -> None:
        self.confidences.append(confidences)
        self.accuracies.append(accuracies)

    def compute(self) -> torch.Tensor:
        """The binned calibration error."""
        return _ce_compute(dim_zero_cat(self.confidences), dim_zero_cat(self.accuracies), self.n_bins, self.norm)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class BinaryCalibrationError(_AbstractCalibrationError):
    """Expected calibration error for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> round(float(BinaryCalibrationError(n_bins=2, device="cpu")(preds, target)), 4)
        0.1167
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self._create_state(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append one batch's confidences and accuracies."""
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_calibration_error_format(preds, target, self.ignore_index)
        self._update_state(*_binary_calibration_error_update(preds, target))


class MulticlassCalibrationError(_AbstractCalibrationError):
    """Top-label expected calibration error for multiclass tasks."""

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self._create_state(n_bins, norm, ignore_index, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append one batch's top-1 confidences and their correctness."""
        if self.validate_args:
            _multiclass_calibration_error_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_calibration_error_format(preds, target, self.ignore_index)
        self._update_state(*_multiclass_calibration_error_update(preds, target))


class CalibrationError:
    """Task router: ``CalibrationError(task=...)`` returns the binary or multiclass variant.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CalibrationError
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> metric = CalibrationError(task="binary", n_bins=2, norm="l1", device="cpu")
        >>> round(float(metric(preds, target)), 4)
        0.29
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, None,
            lambda: BinaryCalibrationError(**kwargs),
            lambda c: MulticlassCalibrationError(c, **kwargs),
            None,
            tasks=ClassificationTaskNoMultilabel,
        )
