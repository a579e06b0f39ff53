"""Modular multilabel ranking metrics (counterpart of ``torchmetrics_tpu/classification/ranking.py``).

A float ``measure`` sum and an int32 ``total``, sum-reduced. With
``validate_args=False`` an update reads nothing back to the host, so it runs in a
captured graph under the engine; the validation's unique-value check reads the host,
and then the update runs eagerly, counted, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multilabel_confusion_matrix_arg_validation
from torchmetrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
    _ranking_format,
    _ranking_reduce,
)
from torchmetrics_tpu_torch.metric import Metric


class _AbstractRanking(Metric):
    is_differentiable: bool = False
    full_state_update: bool = False

    _update_fn = None  # set by each subclass

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold=0.0, ignore_index=ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        preds, target = _ranking_format(preds, target, self.num_labels, self.ignore_index, self.validate_args)
        measure, total = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """The ranking measure averaged over the samples."""
        return _ranking_reduce(self.measure, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class MultilabelCoverageError(_AbstractRanking):
    """Coverage error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelCoverageError
        >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.75, 0.05], [0.05, 0.65, 0.75]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0], [0, 1, 1]])
        >>> round(float(MultilabelCoverageError(num_labels=3, device="cpu")(preds, target)), 4)
        1.6667
    """

    higher_is_better: bool = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_AbstractRanking):
    """Label-ranking average precision."""

    higher_is_better: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_AbstractRanking):
    """Label-ranking loss."""

    higher_is_better: bool = False
    plot_lower_bound: float = 0.0
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
