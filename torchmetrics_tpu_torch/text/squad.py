"""Modular SQuAD (counterpart of ``torchmetrics_tpu/text/squad.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from torchmetrics_tpu_torch.metric import Metric


class SQuAD(Metric):
    """SQuAD exact match and F1 over sum states.

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
        >>> squad = SQuAD(device="cpu")
        >>> result = squad(preds, target)
        >>> print(float(result['exact_match']), float(result['f1']))
        100.0 100.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", 0.0, dist_reduce_fx="sum")
        self.add_state("exact_match", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0, dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        """Add the exact-match and F1 sums of one batch of questions."""
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, torch.Tensor]:
        """Mean exact match and F1, in percent."""
        return _squad_compute(self.f1_score, self.exact_match, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
