"""Modular ROUGE (counterpart of ``torchmetrics_tpu/text/rouge.py``).

One ``cat`` list per (key, score): each update appends one float32 tensor of its
per-sample scores, all of them made in one host-to-device copy.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_compute,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.metric import Metric

_SCORES = ("fmeasure", "precision", "recall")


class ROUGEScore(Metric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum over per-key score lists.

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> preds = 'My name is John'
        >>> target = 'Is your name John'
        >>> rouge = ROUGEScore(rouge_keys='rouge1', device="cpu")
        >>> result = rouge(preds, target)
        >>> print(round(float(result['rouge1_fmeasure']), 4))
        0.75
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        stemmer = None
        if use_stemmer:
            try:
                from nltk.stem.porter import PorterStemmer
            except ImportError as err:
                raise ModuleNotFoundError(
                    "Stemmer support requires `nltk` which is not installed; pass `use_stemmer=False`."
                ) from err
            stemmer = PorterStemmer()
        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.stemmer = stemmer
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate

        for rouge_key in self.rouge_keys:
            for score in _SCORES:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx="cat")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        """Score one batch of corpora and append the per-sample values."""
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]

        output = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            stemmer=self.stemmer,
            normalizer=self.normalizer,
            tokenizer=self.tokenizer,
            accumulate=self.accumulate,
        )
        names = [f"rouge{rouge_key}_{tp}" for rouge_key in output for tp in _SCORES]
        values = [[float(m[tp]) for m in metrics] for metrics in output.values() for tp in _SCORES]
        rows = torch.tensor(values, dtype=torch.float32, device=self.device)
        for name, row in zip(names, rows.unbind()):
            getattr(self, name).append(row)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The mean of each key's per-sample scores."""
        update_output: Dict[str, List[torch.Tensor]] = {}
        for rouge_key in self.rouge_keys_values:
            for tp in _SCORES:
                update_output[f"rouge{rouge_key}_{tp}"] = getattr(self, f"rouge{rouge_key}_{tp}")
        return _rouge_score_compute(update_output, self.device)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
