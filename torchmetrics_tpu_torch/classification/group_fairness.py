"""Modular group fairness (counterpart of ``torchmetrics_tpu/classification/group_fairness.py``).

Per-group int32 tp / fp / tn / fn counters of shape ``(num_groups,)``, sum-reduced,
from one count into ``4 * num_groups`` bins per update. With ``validate_args=False``
an update reads nothing back to the host and runs in a captured graph under the
engine; the validation reads the host (the group range and the label values), and then
the update runs eagerly, counted, as in the JAX package. ``compute`` reads the
argmin / argmax group ids on the host for the result's keys.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores,
    _fairness_compute,
    _fairness_task_validation,
    _groups_reduce,
    _no_target,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_COUNTS = ("tp", "fp", "tn", "fn")


def _num_groups_validation(num_groups: int) -> None:
    if not isinstance(num_groups, int) or num_groups < 2:
        raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")


class _AbstractGroupStatScores(Metric):
    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def _create_states(self, num_groups: int, threshold: float, ignore_index: Optional[int], validate_args: bool) -> None:
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in _COUNTS:
            self.add_state(name, torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_states(self, preds: torch.Tensor, target: torch.Tensor, groups: torch.Tensor) -> None:
        counts = _binary_groups_stat_scores(
            preds, target, groups, self.num_groups, self.threshold, self.ignore_index, self.validate_args
        )
        self.tp = self.tp + counts[:, 0]
        self.fp = self.fp + counts[:, 1]
        self.tn = self.tn + counts[:, 2]
        self.fn = self.fn + counts[:, 3]

    def _counts(self) -> torch.Tensor:
        """The ``(num_groups, 4)`` tp / fp / tn / fn counts."""
        return torch.stack([self.tp, self.fp, self.tn, self.fn], dim=1)


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Per-group tp / fp / tn / fn rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryGroupStatRates
        >>> metric = BinaryGroupStatRates(num_groups=2, device="cpu")
        >>> metric.update(torch.tensor([0.9, 0.2, 0.8, 0.1]), torch.tensor([1, 0, 0, 1]), torch.tensor([0, 0, 1, 1]))
        >>> {k: v.tolist() for k, v in metric.compute().items()}
        {'group_0': [0.5, 0.0, 0.5, 0.0], 'group_1': [0.0, 0.5, 0.0, 0.5]}
    """

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _num_groups_validation(num_groups)
        self._create_states(num_groups, threshold, ignore_index, validate_args)

    def update(self, preds: torch.Tensor, target: torch.Tensor, groups: torch.Tensor) -> None:
        """Accumulate the per-group counters."""
        self._update_states(preds, target, groups)

    def compute(self) -> Dict[str, torch.Tensor]:
        """Each group's [tp, fp, tn, fn] rates."""
        return _groups_reduce(self._counts())


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and / or equal opportunity, keyed by the min / max group ids."""

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _fairness_task_validation(task)
        _num_groups_validation(num_groups)
        self.task = task
        self._create_states(num_groups, threshold, ignore_index, validate_args)

    def update(
        self, preds: torch.Tensor, target: Optional[torch.Tensor] = None, groups: Optional[torch.Tensor] = None
    ) -> None:
        """Accumulate the per-group counters (``target`` is not used for demographic parity)."""
        if groups is None:
            raise ValueError("Expected argument `groups` to be provided")
        if self.task == "demographic_parity":
            if target is not None:
                rank_zero_warn("The task demographic_parity does not require a target.", UserWarning)
            target = _no_target(preds)
        self._update_states(preds, target, groups)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The fairness ratios."""
        return _fairness_compute(self._counts(), self.task)
