"""Modular hinge loss for binary and multiclass tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/hinge.py``).

A float ``measures`` sum (per class in ``one-vs-all`` mode) and an int32 ``total``,
sum-reduced. Every update reads the host once to drop the rows whose target is
ignored, as in the JAX package, so under the engine these updates run eagerly,
counted.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _multiclass_confusion_matrix_format,
)
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_loss_update,
    _drop_ignored_rows,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_tensor_validation,
    _multiclass_hinge_loss_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task


class _AbstractHinge(Metric):
    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def _create_state(self, measures: torch.Tensor) -> None:
        self.add_state("measures", measures, dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, measures: torch.Tensor, total: torch.Tensor) -> None:
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """The mean hinge loss (per class in ``one-vs-all`` mode)."""
        return _hinge_loss_compute(self.measures, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class BinaryHingeLoss(_AbstractHinge):
    """Hinge loss for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHingeLoss
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> round(float(BinaryHingeLoss(device="cpu")(preds, target)), 4)
        0.8167
    """

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(torch.zeros(()))

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch's hinge measures."""
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(
            preds, target, threshold=0.0, ignore_index=self.ignore_index, convert_to_labels=False
        )
        preds, target = _drop_ignored_rows(preds, target)
        self._update_state(*_binary_hinge_loss_update(preds, target, self.squared))


class MulticlassHingeLoss(_AbstractHinge):
    """Hinge loss for multiclass tasks, ``crammer-singer`` or ``one-vs-all``."""

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(torch.zeros(()) if multiclass_mode == "crammer-singer" else torch.zeros(num_classes))

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch's hinge measures."""
        if self.validate_args:
            _multiclass_hinge_loss_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(
            preds, target, ignore_index=self.ignore_index, convert_to_labels=False
        )
        preds, target = _drop_ignored_rows(preds, target)
        self._update_state(*_multiclass_hinge_loss_update(preds, target, self.squared, self.multiclass_mode))


class HingeLoss:
    """Task router: ``HingeLoss(task=...)`` returns the binary or multiclass variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, None,
            lambda: BinaryHingeLoss(squared, **kwargs),
            lambda c: MulticlassHingeLoss(c, squared, multiclass_mode, **kwargs),
            None,
            tasks=ClassificationTaskNoMultilabel,
        )
