"""InfoLM (counterpart of ``torchmetrics_tpu/functional/text/infolm.py``).

The nine information measures are reductions over the vocabulary axis of ``(N, V)``
sentence distributions, on the device. The distributions come from an injected
``model(sentences) -> (N, V)`` or, with ``model_name_or_path``, from the masked-LM
pipeline: for every content position, that token is replaced by ``[MASK]``, the model
runs, and the temperature softmax at that position joins the sentence's distribution
(float64 on the device), weighted by the token's idf or uniformly; special tokens
(PAD / SEP / CLS) are left out. That pipeline reads its token ids back once per call.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)

_EPS = 1e-12


class _InformationMeasure:
    """The nine information measures, each a reduction over the vocabulary axis."""

    def __init__(
        self,
        information_measure: str = "kl_divergence",
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
    ) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Argument `information_measure` expected to be one of {_ALLOWED_INFORMATION_MEASURE}"
                f" but got {information_measure}."
            )
        if information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence") and not isinstance(
            alpha, float
        ):
            raise ValueError(f"Argument `alpha` is expected to be defined for {information_measure}.")
        if information_measure in ("beta_divergence", "ab_divergence") and not isinstance(beta, float):
            raise ValueError(f"Argument `beta` is expected to be defined for {information_measure}.")
        if information_measure == "alpha_divergence" and alpha in (0.0, 1.0):
            raise ValueError(f"Parameter `alpha` is expected to be differened from 0 and 1 for {information_measure}.")
        if information_measure == "beta_divergence" and beta in (0.0, -1.0):
            raise ValueError(f"Parameter `beta` is expected to be differened from 0 and -1 for {information_measure}.")
        if information_measure == "ab_divergence" and any(p in (0.0,) for p in (alpha, beta)) or (
            information_measure == "ab_divergence" and alpha is not None and beta is not None and alpha + beta == 0
        ):
            raise ValueError(
                f"Parameters `alpha`, `beta` and their sum are expected to differ from 0 for {information_measure}."
            )
        self.information_measure = information_measure
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: torch.Tensor, target_distribution: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"_calculate_{self.information_measure}")(preds_distribution, target_distribution)

    @staticmethod
    def _calculate_kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return torch.sum(p * (torch.log(p + _EPS) - torch.log(q + _EPS)), dim=-1)

    def _calculate_alpha_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        a = self.alpha
        return (1.0 / (a * (a - 1))) * (torch.sum(q**a * p ** (1 - a), dim=-1) - 1)

    def _calculate_beta_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        b = self.beta
        term1 = 1.0 / (b * (b + 1)) * torch.sum(p ** (b + 1), dim=-1)
        term2 = 1.0 / b * torch.sum(q * p**b, dim=-1)
        term3 = 1.0 / (b + 1) * torch.sum(q ** (b + 1), dim=-1)
        return term1 - term2 + term3

    def _calculate_ab_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        a, b = self.alpha, self.beta
        term1 = 1.0 / (b * (a + b)) * torch.sum(q ** (a + b), dim=-1)
        term2 = 1.0 / (a * b) * torch.sum(q**a * p**b, dim=-1)
        term3 = 1.0 / (a * (a + b)) * torch.sum(p ** (a + b), dim=-1)
        return term1 - term2 + term3

    def _calculate_renyi_divergence(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        a = self.alpha
        return torch.log(torch.sum(q**a * p ** (1 - a), dim=-1)) / (a - 1)

    @staticmethod
    def _calculate_l1_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(p - q), dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sum((p - q) ** 2, dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return torch.amax(torch.abs(p - q), dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * q), dim=-1), 0.0, 1.0))


def make_hf_masked_lm_distribution_fn(
    model_name_or_path: str,
    temperature: float = 0.25,
    idf: bool = True,
    max_length: int = 512,
    device: Optional[Union[str, torch.device]] = None,
) -> Callable[[List[str]], torch.Tensor]:
    """``sentences -> (N, V)`` distributions on ``device`` (``None``: the card) through
    the masked-LM pipeline of a ``transformers`` checkpoint."""
    from torchmetrics_tpu_torch.utilities.hf import hf_tokenize, load_hf_model_and_tokenizer, model_max_length

    device = resolve_device(device)
    hf_model, tokenizer = load_hf_model_and_tokenizer(model_name_or_path, "AutoModelForMaskedLM")
    max_length = model_max_length(hf_model, max_length)
    token_fn = make_hf_masked_lm_distribution_from_tokens_fn(model_name_or_path, temperature, idf)

    def fn(sentences: List[str]) -> torch.Tensor:
        ids, attn = hf_tokenize(tokenizer, sentences, max_length=max_length, padding="longest", device=device)
        return token_fn(ids, attn)

    return fn


def make_hf_masked_lm_distribution_fns(
    model_name_or_path: str,
    temperature: float = 0.25,
    idf: bool = True,
    max_length: int = 512,
) -> Tuple[Callable[..., Tuple[torch.Tensor, torch.Tensor]], Callable[[torch.Tensor, torch.Tensor], torch.Tensor], int]:
    """``(tokenize_fn, distribution_from_tokens_fn, pad_width)``: the modular metric
    tokenizes at ``update`` (one width, so the token states ride the gather) and makes
    the distributions at ``compute`` over the whole corpus."""
    from torchmetrics_tpu_torch.utilities.hf import hf_tokenize, load_hf_model_and_tokenizer, model_max_length

    hf_model, tokenizer = load_hf_model_and_tokenizer(model_name_or_path, "AutoModelForMaskedLM")
    pad_width = model_max_length(hf_model, max_length)

    def tokenize_fn(sentences: List[str], device: Optional[Union[str, torch.device]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        return hf_tokenize(tokenizer, sentences, max_length=pad_width, padding="max_length", device=device)

    token_fn = make_hf_masked_lm_distribution_from_tokens_fn(model_name_or_path, temperature, idf)
    return tokenize_fn, token_fn, pad_width


def make_hf_masked_lm_distribution_from_tokens_fn(
    model_name_or_path: str,
    temperature: float = 0.25,
    idf: bool = True,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(input_ids, attention_mask) -> (N, V)`` float64 sentence distributions, on the
    device of the token ids."""
    from torchmetrics_tpu_torch.utilities.hf import hf_logits_forward, load_hf_model_and_tokenizer

    hf_model, tokenizer = load_hf_model_and_tokenizer(model_name_or_path, "AutoModelForMaskedLM")
    forward = hf_logits_forward(hf_model)
    mask_token_id = tokenizer.mask_token_id
    if mask_token_id is None:
        raise ValueError(f"Tokenizer for `{model_name_or_path!r}` has no mask token — InfoLM requires a masked LM.")
    special_ids = [i for i in (tokenizer.pad_token_id, tokenizer.sep_token_id, tokenizer.cls_token_id) if i is not None]

    def fn(ids: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        device = ids.device
        # the one host read: which columns hold content, and which tokens are special
        host = torch.stack([ids.to(torch.int64), attn.to(torch.int64)]).cpu().numpy()
        ids_np, attn_np = host[0], host[1]
        # trailing all-pad columns are cut: each forward is O(L^2) attention, and pad
        # positions never join a distribution
        content_cols = np.flatnonzero(attn_np.any(axis=0))
        keep = ids_np.shape[1]
        if content_cols.size and content_cols[-1] + 1 < keep:
            keep = int(content_cols[-1]) + 1
        ids_np, attn_np = ids_np[:, :keep], attn_np[:, :keep]
        ids, attn = ids[:, :keep], attn[:, :keep]
        token_mask = ~np.isin(ids_np, special_ids)
        token_mask_t = torch.from_numpy(token_mask).to(device)
        if idf:
            from torchmetrics_tpu_torch.functional.text.bert import _compute_idf, _idf_weights

            # the token mask (not the attention mask) weighs: special tokens stay out
            pos_w = _idf_weights(ids, token_mask_t, _compute_idf([ids_np], [attn_np])).to(torch.float64)
        else:
            pos_w = token_mask_t.to(torch.float64)

        acc = None
        for pos in range(ids_np.shape[1]):
            if not token_mask[:, pos].any():
                continue
            masked = ids.clone()
            masked[:, pos] = mask_token_id
            logits = forward(masked, attn)  # (N, L, V)
            probs = torch.softmax(logits[:, pos, :].to(torch.float32) / temperature, dim=-1).to(torch.float64)
            contrib = probs * pos_w[:, pos : pos + 1]
            acc = contrib if acc is None else acc + contrib
        if acc is None:
            raise ValueError("No content tokens found in the input sentences.")
        return acc / torch.clamp(pos_w.sum(dim=1, keepdim=True), min=_EPS)

    return fn


def infolm(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    model: Optional[Callable] = None,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """InfoLM; ``model(sentences) -> (N, V)`` distributions, or a masked LM from
    ``model_name_or_path``; ``device`` holds the distributions (``None``: the card).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import infolm
        >>> def model(sentences):
        ...     return torch.softmax(torch.tensor([[float(len(s)), 1.0, 0.5] for s in sentences]), dim=-1)
        >>> print(round(float(infolm(["a cat"], ["a cat"], model=model, device="cpu")), 4))
        0.0
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    device = resolve_device(device)
    if model is None and model_name_or_path is not None:
        model = make_hf_masked_lm_distribution_fn(model_name_or_path, temperature=temperature, idf=idf, device=device)
    if model is None or isinstance(model, str) or not callable(model):
        raise ValueError(
            "Either pass `model_name_or_path` (a cached/local HF masked-LM) or a callable"
            " `model(sentences) -> (N, V) distributions`."
        )
    measure = _InformationMeasure(information_measure, alpha, beta)
    preds_distribution = torch.as_tensor(model(preds), device=device)
    target_distribution = torch.as_tensor(model(target), device=device)
    scores = measure(preds_distribution, target_distribution)
    if return_sentence_level_score:
        return scores.mean(), scores
    return scores.mean()
