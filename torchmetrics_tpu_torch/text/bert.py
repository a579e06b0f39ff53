"""Modular BERTScore (counterpart of ``torchmetrics_tpu/text/bert.py``).

With a tokenizer (``model_name_or_path`` or ``user_tokenizer``), ``update`` tokenizes at
once and keeps the padded ``input_ids`` / ``attention_mask`` as ``cat`` lists of int
tensors at one fixed width, so they ride the cross-process gather and ``compute``
scores the whole corpus (corpus-wide idf included). With no tokenizer at all the
sentences are kept as raw string lists (``dist_reduce_fx=None``), which pass through a
sync untouched. ``compute`` reads the target tokens back once when ``idf`` is on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.text.bert import (
    _resolve_model_and_tokenizer,
    _score_from_tokens,
    _validate_model_inputs,
    bert_score,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class BERTScore(Metric):
    """BERTScore over an injected or a ``transformers`` embedder.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import BERTScore
        >>> table = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
        >>> def tokenizer(sentences):
        ...     ids = torch.tensor([[len(w) for w in s.split()] + [0] * (4 - len(s.split())) for s in sentences])
        ...     return {"input_ids": ids, "attention_mask": (ids > 0).long()}
        >>> metric = BERTScore(model=lambda ids, mask: table[ids], user_tokenizer=tokenizer, max_length=4, device="cpu")
        >>> metric.update(["hello there"], ["hello there"])
        >>> print(round(float(metric.compute()["f1"]), 4))
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    preds: List[str]
    target: List[str]
    pred_input_ids: List[torch.Tensor]
    pred_attention_mask: List[torch.Tensor]
    target_input_ids: List[torch.Tensor]
    target_attention_mask: List[torch.Tensor]

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Optional[Callable] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        # resolved at first use: loading the HF model here would make construction
        # heavy and pickling awkward
        self._forward_fn: Optional[Callable] = None
        self._tokenize_fn: Optional[Callable] = None
        self._pad_width = max_length
        self._resolved = False

        self.add_state("pred_input_ids", [], dist_reduce_fx="cat")
        self.add_state("pred_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("target_input_ids", [], dist_reduce_fx="cat")
        self.add_state("target_attention_mask", [], dist_reduce_fx="cat")
        self.add_state("preds", [], dist_reduce_fx=None)
        self.add_state("target", [], dist_reduce_fx=None)

    def _resolve(self) -> None:
        # the model too, not only the tokenizer: the pad width is capped by the model's
        # position embeddings
        if self._resolved:
            return
        forward, tokenizer, pad_width = _resolve_model_and_tokenizer(
            self.model_name_or_path, self.num_layers, self.model, self.user_tokenizer, self.max_length
        )
        self._forward_fn = self.user_forward_fn if self.user_forward_fn is not None else forward
        self._tokenize_fn = tokenizer
        self._pad_width = pad_width
        self._resolved = True

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Tokenize and keep one batch (token tensors with a tokenizer, else the sentences)."""
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [target]
        if len(preds) != len(target):
            raise ValueError("Number of predicted and reference sentences must be the same!")
        self._resolve()
        if self._tokenize_fn is not None:
            p_tok = self._tokenize_fn(list(preds))
            t_tok = self._tokenize_fn(list(target))
            self.pred_input_ids.append(self._to_width(p_tok["input_ids"]))
            self.pred_attention_mask.append(self._to_width(p_tok["attention_mask"]))
            self.target_input_ids.append(self._to_width(t_tok["input_ids"]))
            self.target_attention_mask.append(self._to_width(t_tok["attention_mask"]))
        else:
            self.preds.extend(preds)
            self.target.extend(target)

    def _to_width(self, arr: Any) -> torch.Tensor:
        """A tokenized batch on the metric's device, right-padded to the state width: a
        tokenizer that pads to each batch's longest sentence still gives ``cat``-able
        states, and zero padding leaves the masked scores unchanged."""
        arr = torch.as_tensor(arr, device=self.device)
        width = self._pad_width
        if arr.shape[1] > width:
            capped = width < self.max_length
            constraint = (
                f"the model's position-embedding capacity ({width}, which capped your"
                f" max_length={self.max_length})"
                if capped
                else f"max_length={width}"
            )
            remedy = (
                "truncate in the tokenizer or use a model with more positions"
                if capped
                else "truncate in the tokenizer or raise `max_length`"
            )
            raise ValueError(
                f"Tokenizer produced width {arr.shape[1]} > {constraint}; {remedy}"
                " (silent truncation here would corrupt scores)."
            )
        if arr.shape[1] < width:
            arr = F.pad(arr, (0, width - arr.shape[1]))
        return arr

    def _has_tokenized_state(self) -> bool:
        state = self.pred_input_ids
        return len(state) > 0 if isinstance(state, list) else state.numel() > 0

    def compute(self) -> Dict[str, torch.Tensor]:
        """Score the corpus: the token states, or the kept sentences."""
        if self._has_tokenized_state():
            if self.rescale_with_baseline:
                raise ValueError("Baseline rescaling requires downloadable baseline files, which are unavailable.")
            self._resolve()
            if self._forward_fn is None:
                _validate_model_inputs(None, self._tokenize_fn)
            pred_tok = {
                "input_ids": dim_zero_cat(self.pred_input_ids),
                "attention_mask": dim_zero_cat(self.pred_attention_mask),
            }
            tgt_tok = {
                "input_ids": dim_zero_cat(self.target_input_ids),
                "attention_mask": dim_zero_cat(self.target_attention_mask),
            }
            precision, recall, f1 = _score_from_tokens(pred_tok, tgt_tok, self._forward_fn, self.idf, self.device)
            return {"precision": precision, "recall": recall, "f1": f1}
        return bert_score(
            preds=self.preds,
            target=self.target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
            user_forward_fn=self.user_forward_fn,
            idf=self.idf,
            device=self.device,
            max_length=self.max_length,
            batch_size=self.batch_size,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
        )

    def __getstate__(self) -> Dict[str, Any]:
        """The resolved callables close over live model objects: drop them, and resolve
        again at first use after unpickling."""
        state = dict(super().__getstate__())
        state.update(_resolved=False, _forward_fn=None, _tokenize_fn=None)
        return state

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
