"""Modular SacreBLEU (counterpart of ``torchmetrics_tpu/text/sacre_bleu.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_update
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from torchmetrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """BLEU's states with sacrebleu's tokenizers.

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.text.sacre_bleu import SacreBLEUScore
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(preds, target)
        >>> print(round(float(metric.compute()), 4))
        0.0
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {AVAILABLE_TOKENIZERS} but got {tokenize}.")
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        """Count the tokenized n-grams of one batch of corpora."""
        self.numerator, self.denominator, self.preds_len, self.target_len = _bleu_score_update(
            preds, target, self.numerator, self.denominator, self.preds_len, self.target_len,
            self.n_gram, self.tokenizer,
        )
