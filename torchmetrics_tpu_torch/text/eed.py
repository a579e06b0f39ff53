"""Modular extended edit distance (counterpart of ``torchmetrics_tpu/text/eed.py``)."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.eed import _eed_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """Extended edit distance over a ``cat`` list of per-sentence scores.

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(preds, target)
        >>> print(round(float(metric.compute()), 4))
        0.2456
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    sentence_eed: List[torch.Tensor]

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for param_name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def update(self, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]) -> None:
        """Append the sentence scores of one batch of corpora."""
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        self.sentence_eed.extend(torch.tensor([s], dtype=torch.float32, device=self.device) for s in scores)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The mean extended edit distance (and the sentence scores when asked for)."""
        # after a sync the cat state is one tensor, not a list
        state = self.sentence_eed
        if (len(state) == 0) if isinstance(state, list) else (state.numel() == 0):
            average = torch.zeros((), device=self.device)
            scores = torch.zeros((0,), device=self.device)
        else:
            scores = dim_zero_cat(state)
            average = scores.mean()
        if self.return_sentence_level_score:
            return average, scores
        return average

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
