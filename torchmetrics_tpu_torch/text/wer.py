"""Modular WER, CER, MER, WIL and WIP (counterpart of ``torchmetrics_tpu/text/wer.py``).

Each update tokenizes and runs the edit distances on the host and adds the counts to
float32 sum states as Python scalars: no host-to-device copy per update.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.text.cer import _cer_compute, _cer_update
from torchmetrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from torchmetrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update
from torchmetrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update
from torchmetrics_tpu_torch.functional.text.wip import _wip_compute, _wip_update
from torchmetrics_tpu_torch.metric import Metric


class _ErrorTotal(Metric):
    """``errors`` / ``total`` sums filled by a host update (WER, CER, MER)."""

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    _update_fn = staticmethod(_wer_update)
    _compute_fn = staticmethod(_wer_compute)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Add one batch's edit operations and totals."""
        errors, total = self._update_fn(preds, target)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return self._compute_fn(self.errors, self.total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class WordErrorRate(_ErrorTotal):
    """Word error rate.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordErrorRate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> wer = WordErrorRate(device="cpu")
        >>> print(float(wer(preds, target)))
        0.5
    """


class CharErrorRate(_ErrorTotal):
    """Character error rate."""

    _update_fn = staticmethod(_cer_update)
    _compute_fn = staticmethod(_cer_compute)


class MatchErrorRate(_ErrorTotal):
    """Match error rate."""

    plot_upper_bound: float = 1.0

    _update_fn = staticmethod(_mer_update)
    _compute_fn = staticmethod(_mer_compute)


class _WordInfo(Metric):
    """``errors`` / ``target_total`` / ``preds_total`` sums (WIL, WIP)."""

    is_differentiable: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _update_fn = staticmethod(_wil_update)
    _compute_fn = staticmethod(_wil_compute)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", 0.0, dist_reduce_fx="sum")
        self.add_state("target_total", 0.0, dist_reduce_fx="sum")
        self.add_state("preds_total", 0.0, dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Add one batch's hit statistics."""
        errors, target_total, preds_total = self._update_fn(preds, target)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> torch.Tensor:
        return self._compute_fn(self.errors, self.target_total, self.preds_total)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class WordInfoLost(_WordInfo):
    """Word information lost."""

    higher_is_better: bool = False


class WordInfoPreserved(_WordInfo):
    """Word information preserved."""

    higher_is_better: bool = True

    _update_fn = staticmethod(_wip_update)
    _compute_fn = staticmethod(_wip_compute)
