"""Modular F-beta and F1 for binary, multiclass and multilabel tasks, and their task
routers (counterpart of ``torchmetrics_tpu/classification/f_beta.py``). Each class is
its stat-scores variant with another ``compute``."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _route_stat_scores,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce, _validate_beta
from torchmetrics_tpu_torch.metric import Metric


class BinaryFBetaScore(BinaryStatScores):
    """F-beta for binary tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        beta: float,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index, validate_args=False,
            **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average="binary", multidim_average=self.multidim_average)


class MulticlassFBetaScore(MulticlassStatScores):
    """F-beta for multiclass tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def __init__(
        self,
        beta: float,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, top_k=top_k, average=average, multidim_average=multidim_average,
            ignore_index=ignore_index, validate_args=False, **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average)


class MultilabelFBetaScore(MultilabelStatScores):
    """F-beta for multilabel tasks."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(
        self,
        beta: float,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, threshold=threshold, average=average, multidim_average=multidim_average,
            ignore_index=ignore_index, validate_args=False, **kwargs,
        )
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._final_state()
        return _fbeta_reduce(
            tp, fp, tn, fn, self.beta, average=self.average, multidim_average=self.multidim_average, multilabel=True
        )


class BinaryF1Score(BinaryFBetaScore):
    """F1 for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryF1Score
        >>> metric = BinaryF1Score(device="cpu")
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> round(float(metric(preds, torch.tensor([1, 0, 1, 1, 0, 0]))), 4)
        0.6667
    """

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0, threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index,
            validate_args=validate_args, **kwargs,
        )


class MulticlassF1Score(MulticlassFBetaScore):
    """F1 for multiclass tasks."""

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0, num_classes=num_classes, top_k=top_k, average=average, multidim_average=multidim_average,
            ignore_index=ignore_index, validate_args=validate_args, **kwargs,
        )


class MultilabelF1Score(MultilabelFBetaScore):
    """F1 for multilabel tasks."""

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            beta=1.0, num_labels=num_labels, threshold=threshold, average=average, multidim_average=multidim_average,
            ignore_index=ignore_index, validate_args=validate_args, **kwargs,
        )


class FBetaScore:
    """Task router: ``FBetaScore(task=..., beta=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        beta: float = 1.0,
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
            BinaryFBetaScore, MulticlassFBetaScore, MultilabelFBetaScore,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            beta=beta, **kwargs,
        )


class F1Score:
    """Task router: ``F1Score(task=...)`` returns the binary, multiclass or multilabel variant.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import F1Score
        >>> f1 = F1Score(task="multiclass", num_classes=3, device="cpu")
        >>> round(float(f1(torch.tensor([0, 2, 1, 0, 0, 1]), torch.tensor([0, 1, 2, 0, 1, 2]))), 4)
        0.3333
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
            BinaryF1Score, MulticlassF1Score, MultilabelF1Score,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )
