"""Modular confusion matrices for binary, multiclass and multilabel tasks, and the task
router (counterpart of ``torchmetrics_tpu/classification/confusion_matrix.py``).

State: one int32 matrix, ``(2, 2)``, ``(C, C)`` or ``(L, 2, 2)``, sum-reduced across
processes.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.engine.statespec import update_family
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _zero_rows_neutral
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import _route_task


class _ConfusionMatrix(Metric):
    """The one ``confmat`` state; ``normalize`` is compute-only."""

    is_differentiable = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    confmat: torch.Tensor

    def _init_confmat(self, shape: tuple, ignore_index: Optional[int], normalize: Optional[str], validate_args: bool):
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum")

    def compute(self) -> torch.Tensor:
        """Final (normalized) matrix."""
        return _confusion_matrix_reduce(self.confmat, self.normalize)

    def _engine_pad_rows_neutral(self, inputs) -> bool:
        """Whether bucketing's zero pad rows count as they would alone (``engine/bucketing.py``)."""
        return _zero_rows_neutral(getattr(self, "threshold", None), inputs)


class BinaryConfusionMatrix(_ConfusionMatrix):
    """``(2, 2)`` confusion matrix for binary tasks: rows are targets, columns predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> metric = BinaryConfusionMatrix(device="cpu")
        >>> metric(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0])).tolist()
        [[2, 0], [1, 1]]
    """

    # engine shape-bucketing opt-in (engine/bucketing.py): a sum of per-row counts
    _engine_row_additive = True

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self._init_confmat((2, 2), ignore_index, normalize, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch into the matrix."""
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        preds, target = _binary_confusion_matrix_format(preds, target, self.threshold, self.ignore_index)
        self.confmat = self.confmat + _binary_confusion_matrix_update(preds, target)

    def _cse_signature(self) -> tuple:
        """Reduction signature (``engine/statespec.py``): matrices with matching threshold
        and ``ignore_index`` share one ``confmat``."""
        return (*update_family(self), float(self.threshold), self.ignore_index)


class MulticlassConfusionMatrix(_ConfusionMatrix):
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

    # engine shape-bucketing opt-in (engine/bucketing.py): a sum of per-row counts
    _engine_row_additive = True

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
        self._init_confmat((num_classes, num_classes), ignore_index, normalize, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch into the matrix."""
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target = _multiclass_confusion_matrix_format(preds, target, self.ignore_index)
        self.confmat = self.confmat + _multiclass_confusion_matrix_update(preds, target, self.num_classes)

    def _cse_signature(self) -> tuple:
        """Reduction signature (``engine/statespec.py``): matrices with matching
        ``num_classes`` / ``ignore_index`` share one ``confmat``."""
        return (*update_family(self), int(self.num_classes), self.ignore_index)


class MultilabelConfusionMatrix(_ConfusionMatrix):
    """``(L, 2, 2)`` confusion matrices for multilabel tasks, one per label."""

    # engine shape-bucketing opt-in (engine/bucketing.py): a sum of per-row counts
    _engine_row_additive = True

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        normalize: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self._init_confmat((num_labels, 2, 2), ignore_index, normalize, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch into the matrices."""
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target = _multilabel_confusion_matrix_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self.confmat = self.confmat + _multilabel_confusion_matrix_update(preds, target, self.num_labels)

    def _cse_signature(self) -> tuple:
        """Reduction signature (``engine/statespec.py``): matrices with matching
        ``num_labels``, threshold and ``ignore_index`` share one ``confmat``."""
        return (*update_family(self), int(self.num_labels), float(self.threshold), self.ignore_index)


class ConfusionMatrix:
    """Task router: ``ConfusionMatrix(task=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        normalize: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryConfusionMatrix(threshold, **kwargs),
            lambda c: MulticlassConfusionMatrix(c, **kwargs),
            lambda n: MultilabelConfusionMatrix(n, threshold, **kwargs),
        )
