"""Modular exact match for multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/exact_match.py``).

Global: two int32 counters, ``correct`` and ``total``, sum-reduced; the update runs in
a captured graph under the engine. Samplewise: ``correct`` is a cat list of per-sample
0/1 values and ``total`` holds the last batch's positions per sample, mean-reduced, as
in the JAX package; the list state makes the engine run such an update eagerly,
counted.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_format,
    _multilabel_exact_match_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import ClassificationTaskNoBinary, _route_task


class _AbstractExactMatch(Metric):
    """The ``correct`` / ``total`` states."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def _create_state(self, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="mean")
        else:
            self.add_state("correct", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, correct: torch.Tensor, total: torch.Tensor) -> None:
        if self.multidim_average == "samplewise":
            self.correct.append(correct)
            self.total = total
        else:
            self.correct = self.correct + correct
            self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """The exact-match ratio (per sample when samplewise)."""
        correct = dim_zero_cat(self.correct) if isinstance(self.correct, list) else self.correct
        return _exact_match_reduce(correct, self.total)


class MulticlassExactMatch(_AbstractExactMatch):
    """Exact match for multidim multiclass tasks: ``(N, C, ...)`` scores or ``(N, ...)``
    labels against ``(N, ...)`` targets.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
        >>> target = torch.tensor([[[0, 1], [2, 1], [0, 2]], [[1, 1], [2, 0], [1, 2]]])
        >>> preds = torch.tensor([[[0, 1], [2, 1], [0, 2]], [[2, 2], [2, 1], [1, 0]]])
        >>> float(MulticlassExactMatch(num_classes=3, device="cpu")(preds, target))
        0.5
    """

    def __init__(
        self,
        num_classes: int,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        self._update_state(*_multiclass_exact_match_update(preds, target, self.multidim_average, self.ignore_index))


class MultilabelExactMatch(_AbstractExactMatch):
    """Exact match for multilabel tasks: a sample matches when all its labels do."""

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target = _multilabel_exact_match_format(preds, target, self.num_labels, self.threshold, self.ignore_index)
        self._update_state(*_multilabel_exact_match_update(preds, target, self.num_labels, self.multidim_average))


class ExactMatch:
    """Task router: ``ExactMatch(task=...)`` returns the multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update(
            {"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args}
        )
        return _route_task(
            task, num_classes, num_labels,
            None,
            lambda c: MulticlassExactMatch(c, **kwargs),
            lambda n: MultilabelExactMatch(n, threshold, **kwargs),
            tasks=ClassificationTaskNoBinary,
        )
