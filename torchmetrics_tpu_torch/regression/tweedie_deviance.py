"""Modular Tweedie deviance score (counterpart of ``torchmetrics_tpu/regression/tweedie_deviance.py``).

An eager update reads the host for the power's domain checks; under the engine the
checks are skipped inside the update body, so the update is captured at every power,
as the JAX engine compiles it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
    _tweedie_power_validation,
)
from torchmetrics_tpu_torch.metric import Metric


class TweedieDevianceScore(Metric):
    """Tweedie deviance of order ``power``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import TweedieDevianceScore
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> round(float(TweedieDevianceScore(power=1.5, device="cpu")(preds, target)), 4)
        0.112
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _tweedie_power_validation(power)
        self.power = power
        self.add_state("sum_deviance_score", 0.0, dist_reduce_fx="sum")
        self.add_state("num_observations", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, targets: torch.Tensor) -> None:
        """Accumulate the deviance sum and the element count."""
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> torch.Tensor:
        """The mean deviance."""
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
