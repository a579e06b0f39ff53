"""Modular Dice score with the legacy input auto-format (counterpart of
``torchmetrics_tpu/classification/dice.py``).

Global: int32 per-class tp / fp / fn counters, sum-reduced; an update on ``(N, C)``
scores runs in a captured graph under the engine. Samplewise (``mdmc_average=
"samplewise"`` or ``average="samples"``): the counts are cat lists, so the engine runs
such an update eagerly, counted.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.dice import (
    _ALLOWED_AVERAGE,
    _dice_compute,
    _dice_format,
    _dice_update,
    _samplewise_dice,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_COUNTS = ("tp", "fp", "fn")


class Dice(Metric):
    """Dice score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> float(Dice(average="micro", num_classes=3, device="cpu")(preds, target))
        0.25
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if average not in _ALLOWED_AVERAGE:
            raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
        if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self._samplewise = mdmc_average == "samplewise" or average == "samples"
        for name in _COUNTS:
            if self._samplewise:
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(num_classes or 2, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate the tp / fp / fn counts of one batch."""
        preds_oh, target_oh = _dice_format(preds, target, self.threshold, self.top_k, self.num_classes)
        tp, fp, fn = _dice_update(preds_oh, target_oh, self.ignore_index, "samplewise" if self._samplewise else None)
        if self._samplewise:
            self.tp.append(tp)
            self.fp.append(fp)
            self.fn.append(fn)
        else:
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.fn = self.fn + fn

    def compute(self) -> torch.Tensor:
        """The averaged dice score."""
        tp, fp, fn = (dim_zero_cat(getattr(self, k)) for k in _COUNTS)
        if self.mdmc_average == "samplewise" and self.average != "samples":
            return _samplewise_dice(tp, fp, fn, self.zero_division)
        return _dice_compute(tp, fp, fn, average=self.average, zero_division=self.zero_division)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
