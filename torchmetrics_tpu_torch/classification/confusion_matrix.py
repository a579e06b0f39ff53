"""Modular multiclass confusion matrix (counterpart of ``torchmetrics_tpu/classification/confusion_matrix.py``).

State: one int32 ``(C, C)`` matrix, sum-reduced across processes.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.engine.statespec import update_family
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_compute,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
)
from torchmetrics_tpu_torch.metric import Metric


def _update_family(metric: Metric) -> tuple:
    """Identity of the state-producing update body for the CSE signature (the one
    shared keying rule, ``engine/statespec.update_family``)."""
    return update_family(metric)


class MulticlassConfusionMatrix(Metric):
    """``(C, C)`` confusion matrix for multiclass tasks: rows are targets, columns predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        tensor([[1, 1, 0],
                [0, 1, 0],
                [0, 0, 1]], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    confmat: torch.Tensor

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch into the matrix."""
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, self.num_classes)

    def _cse_signature(self) -> tuple:
        """Reduction signature (``engine/statespec.py``): ``normalize`` is compute-only,
        so matrices with matching ``num_classes`` / ``ignore_index`` share one ``confmat``."""
        return (*_update_family(self), int(self.num_classes), self.ignore_index)

    def compute(self) -> torch.Tensor:
        """Final (normalized) matrix."""
        return _multiclass_confusion_matrix_compute(self.confmat, self.normalize)
