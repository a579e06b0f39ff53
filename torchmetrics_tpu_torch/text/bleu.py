"""Modular BLEU (counterpart of ``torchmetrics_tpu/text/bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from torchmetrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """BLEU over per-order numerator / denominator sum states.

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu = BLEUScore(device="cpu")
        >>> print(round(float(bleu(preds, target)), 4))
        0.7598
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram

        self.add_state("preds_len", 0.0, dist_reduce_fx="sum")
        self.add_state("target_len", 0.0, dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram), dist_reduce_fx="sum")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        """Count the n-grams of one batch of corpora."""
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        self.numerator, self.denominator, self.preds_len, self.target_len = _bleu_score_update(
            preds_, target_, self.numerator, self.denominator, self.preds_len, self.target_len,
            self.n_gram, _tokenize_fn,
        )

    def compute(self) -> torch.Tensor:
        """Corpus BLEU."""
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.weights, self.smooth
        )

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
