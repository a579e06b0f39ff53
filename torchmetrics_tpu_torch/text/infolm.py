"""Modular InfoLM (counterpart of ``torchmetrics_tpu/text/infolm.py``).

With ``model_name_or_path`` the metric tokenizes at ``update`` and keeps fixed-width
``input_ids`` / ``attention_mask`` as ``cat`` lists of int tensors, so a multi-process
eval makes the distributions (and the corpus idf) over the whole gathered corpus. With
an injected ``model(sentences) -> (N, V)`` the raw sentences are kept as string lists
(``dist_reduce_fx=None``), which pass through a sync untouched.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.infolm import (
    _InformationMeasure,
    infolm,
    make_hf_masked_lm_distribution_fns,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class InfoLM(Metric):
    """InfoLM over an injected or a ``transformers`` masked LM.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import InfoLM
        >>> def model(sentences):
        ...     return torch.softmax(torch.tensor([[float(len(s)), 1.0, 0.5] for s in sentences]), dim=-1)
        >>> metric = InfoLM(model=model, device="cpu")
        >>> metric.update(["a cat", "a dog"], ["a cat", "the dog"])
        >>> print(round(float(metric.compute()), 4))
        0.0161
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    preds: List[str]
    target: List[str]
    pred_input_ids: List[torch.Tensor]
    pred_attention_mask: List[torch.Tensor]
    target_input_ids: List[torch.Tensor]
    target_attention_mask: List[torch.Tensor]

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        model: Optional[Callable] = None,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.model = model
        self.return_sentence_level_score = return_sentence_level_score
        # resolved at first use; dropped on pickling (closures over live models)
        self._tokenize_fn: Optional[Callable] = None
        self._dist_fn: Optional[Callable] = None
        self._resolved = False

        self.add_state("pred_input_ids", [], dist_reduce_fx="cat")
        self.add_state("pred_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("preds", [], dist_reduce_fx=None)
        self.add_state("target", [], dist_reduce_fx=None)

    def _resolve(self) -> None:
        if self._resolved:
            return
        if self.model is None and self.model_name_or_path is not None:
            self._tokenize_fn, self._dist_fn, _ = make_hf_masked_lm_distribution_fns(
                self.model_name_or_path, temperature=self.temperature, idf=self.idf
            )
        self._resolved = True

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Tokenize and keep one batch (token tensors on the HF route, else the sentences)."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        if len(preds) != len(target):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        self._resolve()
        if self._tokenize_fn is not None:
            p_ids, p_attn = self._tokenize_fn(list(preds), device=self.device)
            t_ids, t_attn = self._tokenize_fn(list(target), device=self.device)
            self.pred_input_ids.append(p_ids)
            self.pred_attention_mask.append(p_attn)
            self.target_input_ids.append(t_ids)
            self.target_attention_mask.append(t_attn)
        else:
            self.preds.extend(preds)
            self.target.extend(target)

    def _has_tokenized_state(self) -> bool:
        state = self.pred_input_ids
        return len(state) > 0 if isinstance(state, list) else state.numel() > 0

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Score the corpus: the token states, or the kept sentences."""
        if self._has_tokenized_state():
            self._resolve()
            measure = _InformationMeasure(self.information_measure, self.alpha, self.beta)
            preds_distribution = self._dist_fn(dim_zero_cat(self.pred_input_ids), dim_zero_cat(self.pred_attention_mask))
            target_distribution = self._dist_fn(
                dim_zero_cat(self.target_input_ids), dim_zero_cat(self.target_attention_mask)
            )
            scores = measure(preds_distribution, target_distribution)
            if self.return_sentence_level_score:
                return scores.mean(), scores
            return scores.mean()
        return infolm(
            self.preds,
            self.target,
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            model=self.model,
            return_sentence_level_score=self.return_sentence_level_score,
            device=self.device,
        )

    def __getstate__(self) -> dict:
        """The resolved closures hold live models: drop them, resolve again after unpickling."""
        state = dict(super().__getstate__())
        state.update(_resolved=False, _tokenize_fn=None, _dist_fn=None)
        return state

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
