"""Modular specificity for binary, multiclass and multilabel tasks, and the task
router (counterpart of ``torchmetrics_tpu/classification/specificity.py``). Each class
is its stat-scores variant with another ``compute``; the multiclass one runs kernel
K1 where its gate admits the inputs."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _route_stat_scores,
)
from torchmetrics_tpu_torch.functional.classification.specificity import _specificity_reduce
from torchmetrics_tpu_torch.metric import Metric


class BinarySpecificity(BinaryStatScores):
    """Specificity = tn / (tn + fp) for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificity
        >>> metric = BinarySpecificity(device="cpu")
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(metric(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.6667
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Specificity for multiclass tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)


class MultilabelSpecificity(MultilabelStatScores):
    """Specificity for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _specificity_reduce(
            tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class Specificity:
    """Task router: ``Specificity(task=...)`` returns the binary, multiclass or multilabel variant."""

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
            BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )
