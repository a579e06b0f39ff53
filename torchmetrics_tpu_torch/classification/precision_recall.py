"""Modular precision and recall for binary, multiclass and multilabel tasks, and their
task routers (counterpart of ``torchmetrics_tpu/classification/precision_recall.py``).
Each class is its stat-scores variant with another ``compute``; the multiclass ones
run kernel K1 where its gate admits the inputs."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _route_stat_scores,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce
from torchmetrics_tpu_torch.metric import Metric


class _BinaryPR(BinaryStatScores):
    _stat: str

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average
        )


class _MulticlassPR(MulticlassStatScores):
    _stat: str

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average
        )


class _MultilabelPR(MultilabelStatScores):
    _stat: str

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryPrecision(_BinaryPR):
    """Precision = tp / (tp + fp) for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecision
        >>> metric = BinaryPrecision(device="cpu")
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(metric(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.6667
    """

    _stat = "precision"


class MulticlassPrecision(_MulticlassPR):
    """Precision for multiclass tasks."""

    _stat = "precision"


class MultilabelPrecision(_MultilabelPR):
    """Precision for multilabel tasks."""

    _stat = "precision"


class BinaryRecall(_BinaryPR):
    """Recall = tp / (tp + fn) for binary tasks."""

    _stat = "recall"


class MulticlassRecall(_MulticlassPR):
    """Recall for multiclass tasks."""

    _stat = "recall"


class MultilabelRecall(_MultilabelPR):
    """Recall for multilabel tasks."""

    _stat = "recall"


class Precision:
    """Task router: ``Precision(task=...)`` returns the binary, multiclass or multilabel variant."""

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
            BinaryPrecision, MulticlassPrecision, MultilabelPrecision,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )


class Recall:
    """Task router: ``Recall(task=...)`` returns the binary, multiclass or multilabel variant."""

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
            BinaryRecall, MulticlassRecall, MultilabelRecall,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )
