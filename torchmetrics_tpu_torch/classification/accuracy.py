"""Modular accuracy for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/accuracy.py``). Each class is its
stat-scores variant with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _route_stat_scores,
)
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce
from torchmetrics_tpu_torch.metric import Metric


class BinaryAccuracy(BinaryStatScores):
    """Accuracy for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryAccuracy(device="cpu")
        >>> preds = torch.tensor([0.11, 0.22, 0.84, 0.73, 0.33, 0.92])
        >>> round(float(metric(preds, torch.tensor([0, 1, 0, 1, 0, 1]))), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        """(tp + tn) / (tp + tn + fp + fn) over the accumulated state."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassAccuracy(MulticlassStatScores):
    """Accuracy for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.1, 0.8, 0.1], [0.7, 0.2, 0.1], [0.2, 0.2, 0.6]])
        >>> float(metric(preds, torch.tensor([1, 0, 1])))
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        """Averaged accuracy over the accumulated state."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelAccuracy(MultilabelStatScores):
    """Accuracy for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        """Averaged accuracy over the accumulated state."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Accuracy:
    """Task router: ``Accuracy(task=...)`` returns the binary, multiclass or multilabel variant.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Accuracy
        >>> metric = Accuracy(task="binary", device="cpu")
        >>> round(float(metric(torch.tensor([0.2, 0.8, 0.6, 0.1]), torch.tensor([0, 1, 0, 0]))), 4)
        0.75
    """

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _route_stat_scores(
            BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )
