"""Modular Cohen's kappa for binary and multiclass tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/cohen_kappa.py``). Each class is its
confusion matrix with another ``compute``; ``weights`` is compute-only."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce, _validate_weights
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoMultilabel, _route_task


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Cohen's kappa for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCohenKappa
        >>> metric = BinaryCohenKappa(device="cpu")
        >>> float(metric(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0])))
        0.5
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _validate_weights(weights)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Cohen's kappa for multiclass tasks."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _validate_weights(weights)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa:
    """Task router: ``CohenKappa(task=...)`` returns the binary or multiclass variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, None,
            lambda: BinaryCohenKappa(threshold, **kwargs),
            lambda c: MulticlassCohenKappa(c, **kwargs),
            None,
            tasks=ClassificationTaskNoMultilabel,
        )
