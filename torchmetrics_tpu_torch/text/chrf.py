"""Modular chrF (counterpart of ``torchmetrics_tpu/text/chrf.py``): six per-order sum
states, and a ``cat`` list of 0-d sentence scores when they are asked for."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.chrf import _chrf_score_compute, _chrf_score_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATES = (
    "total_preds_char_n_grams",
    "total_preds_word_n_grams",
    "total_target_char_n_grams",
    "total_target_word_n_grams",
    "total_matching_char_n_grams",
    "total_matching_word_n_grams",
)


class CHRFScore(Metric):
    """chrF / chrF++.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> chrf = CHRFScore(device="cpu")
        >>> print(round(float(chrf(preds, target)), 4))
        0.4942
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        self.n_char_order = n_char_order
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        self.n_word_order = n_word_order
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        for name, n in zip(_STATES, (n_char_order, n_word_order) * 3):
            self.add_state(name, torch.zeros(n), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        """Add the n-gram statistics of one batch of corpora."""
        *states, sentence_scores = _chrf_score_update(
            preds,
            target,
            *(getattr(self, name) for name in _STATES),
            self.n_char_order,
            self.n_word_order,
            self.n_order,
            self.beta,
            self.lowercase,
            self.whitespace,
            [] if self.return_sentence_level_score else None,
        )
        for name, value in zip(_STATES, states):
            setattr(self, name, value)
        if self.return_sentence_level_score and sentence_scores:
            self.sentence_chrf_score.extend(sentence_scores)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Corpus chrF (and the sentence scores when asked for)."""
        score = _chrf_score_compute(*(getattr(self, name) for name in _STATES), self.n_order, self.beta)
        if self.return_sentence_level_score:
            return score, dim_zero_cat([torch.atleast_1d(s) for s in self.sentence_chrf_score])
        return score

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
