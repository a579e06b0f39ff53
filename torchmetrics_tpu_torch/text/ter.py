"""Modular translation edit rate (counterpart of ``torchmetrics_tpu/text/ter.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class TranslationEditRate(Metric):
    """Translation edit rate.

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.text.ter import TranslationEditRate
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(preds, target)
        >>> print(round(float(metric.compute()), 4))
        0.2222
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(normalize, bool):
            raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
        if not isinstance(no_punctuation, bool):
            raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
        if not isinstance(lowercase, bool):
            raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
        if not isinstance(asian_support, bool):
            raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", 0.0, dist_reduce_fx="sum")
        self.add_state("total_tgt_length", 0.0, dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Add the edit counts of one batch of corpora."""
        self.total_num_edits, self.total_tgt_length, sentence_scores = _ter_update(
            preds,
            target,
            self.tokenizer,
            self.total_num_edits,
            self.total_tgt_length,
            [] if self.return_sentence_level_score else None,
        )
        if self.return_sentence_level_score and sentence_scores:
            self.sentence_ter.extend(sentence_scores)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Corpus TER (and the sentence scores when asked for)."""
        ter = _ter_compute(self.total_num_edits, self.total_tgt_length)
        if self.return_sentence_level_score:
            return ter, dim_zero_cat(self.sentence_ter)
        return ter

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
