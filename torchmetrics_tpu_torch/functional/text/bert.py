"""BERTScore (counterpart of ``torchmetrics_tpu/functional/text/bert.py``).

The greedy cosine matching is one batched ``torch.bmm`` of the normalized embeddings,
``(N, Lp, D) @ (N, D, Lt)``, at full float32 (TF32 off, as the JAX package asks for
``Precision.HIGHEST``), then masked maxima and weighted means on the device. The idf
weights are a ``torch.searchsorted`` into a sorted token table plus a gather, on the
device; the table is counted on the host from the target tokens, which the modular
metric reads back once per ``compute``.

The transformer comes either from ``model_name_or_path`` (``utilities/hf.py``: a torch
``AutoModel`` and ``AutoTokenizer``, offline error when the weights are not there) or
is injected: ``user_tokenizer(sentences) -> {"input_ids", "attention_mask"}`` and
``model(input_ids, attention_mask) -> (N, L, D)`` embeddings.

The batches reach the encoder at the rows and widths the tokenizer gave them. The JAX
package pads both to power-of-two buckets (``TORCHMETRICS_TPU_BERT_BUCKETS``) to bound
the retraces of its jitted cosine core; the port compiles nothing per shape, so the
padding would only add encoder work and has no counterpart.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.models._common import full_float32


def _validate_model_inputs(model: Any, user_tokenizer: Any) -> None:
    if model is None or isinstance(model, str):
        raise ModuleNotFoundError(
            f"Default transformer backbones (`model_name_or_path={model!r}`) require downloadable pretrained"
            " weights, which are not available. Pass a callable `model(input_ids, attention_mask) -> embeddings`"
            " plus a `user_tokenizer`, as in the reference's own-model example."
        )
    if not callable(model):
        raise ValueError("Argument `model` must be a callable embedding model.")
    if user_tokenizer is None or not callable(user_tokenizer):
        raise ValueError("A callable `user_tokenizer` returning {'input_ids', 'attention_mask'} is required.")


def _host(x: Any) -> np.ndarray:
    """A tokenizer output or a state as a numpy array: a CUDA tensor is read back here."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compute_idf(token_batches: List[Any], mask_batches: List[Any]) -> Dict[int, float]:
    """Inverse document frequency of each token over the target corpus."""
    doc_counts: Counter = Counter()
    num_docs = 0
    for ids, mask in zip(token_batches, mask_batches):
        if isinstance(ids, torch.Tensor) and isinstance(mask, torch.Tensor) and ids.device.type != "cpu":
            # one read of both: the token ids and the mask in one copy
            both = torch.stack([ids.to(torch.int64), mask.to(torch.int64)]).cpu().numpy()
            ids_np, mask_np = both[0], both[1].astype(bool)
        else:
            ids_np, mask_np = _host(ids), _host(mask).astype(bool)
        for row, mrow in zip(ids_np, mask_np):
            num_docs += 1
            doc_counts.update(set(row[mrow].tolist()))
    return {tok: math.log((num_docs + 1) / (cnt + 1)) for tok, cnt in doc_counts.items()}


def _idf_table(idf: Dict[int, float], device: Union[str, torch.device]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted token ids, weights)`` on ``device``, for the searchsorted gather."""
    keys = np.fromiter(sorted(idf), dtype=np.int64, count=len(idf))
    vals = np.asarray([idf[int(k)] for k in keys], dtype=np.float32)
    if keys.size == 0:  # an empty corpus: a one-slot miss table
        keys = np.asarray([-1], dtype=np.int64)
        vals = np.zeros(1, dtype=np.float32)
    return torch.from_numpy(keys).to(device), torch.from_numpy(vals).to(device)


def _idf_weights(
    ids: torch.Tensor,
    mask: torch.Tensor,
    table: Optional[Union[Dict[int, float], Tuple[torch.Tensor, torch.Tensor]]],
) -> torch.Tensor:
    """Per-token weights: the idf table's value (0 for a token not in it) or, without a
    table, the mask; masked positions weigh 0."""
    mask_f = mask.to(torch.float32)
    if table is None:
        return mask_f
    if isinstance(table, dict):
        table = _idf_table(table, ids.device)
    keys, vals = table
    ids_k = ids.to(keys.dtype)
    pos = torch.clamp(torch.searchsorted(keys, ids_k), 0, keys.shape[0] - 1)
    w = torch.where(keys[pos] == ids_k, vals[pos], 0.0)
    return w * mask_f


def _greedy_cosine_scores(
    pred_emb: torch.Tensor,
    pred_mask: torch.Tensor,
    tgt_emb: torch.Tensor,
    tgt_mask: torch.Tensor,
    pred_w: torch.Tensor,
    tgt_w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pair precision, recall and F1 of greedy token matching.

    ``pred_emb``: (N, Lp, D); ``tgt_emb``: (N, Lt, D); masks and weights (N, L*).
    """

    def _norm(e: torch.Tensor) -> torch.Tensor:
        return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)

    pred_n = _norm(pred_emb.to(torch.float32))
    tgt_n = _norm(tgt_emb.to(torch.float32))
    with full_float32():
        sim = torch.bmm(pred_n, tgt_n.transpose(1, 2))  # (N, Lp, Lt)
    valid = (pred_mask[:, :, None] * tgt_mask[:, None, :]) > 0
    sim_masked = torch.where(valid, sim, -torch.inf)
    best_for_pred = torch.where(pred_mask > 0, sim_masked.amax(dim=2), 0.0)
    best_for_tgt = torch.where(tgt_mask > 0, sim_masked.amax(dim=1), 0.0)
    precision = (best_for_pred * pred_w).sum(1) / torch.clamp(pred_w.sum(1), min=1e-12)
    recall = (best_for_tgt * tgt_w).sum(1) / torch.clamp(tgt_w.sum(1), min=1e-12)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return precision, recall, f1


def _resolve_model_and_tokenizer(
    model_name_or_path: Optional[str],
    num_layers: Optional[int],
    model: Optional[Callable],
    user_tokenizer: Optional[Callable],
    max_length: int,
) -> Tuple[Optional[Callable], Optional[Callable], int]:
    """``(forward, tokenizer, pad width)``; on the HF route the tokenizer pads to the
    model-capped width, so every batch has one width."""
    pad_width = max_length
    if model is None and model_name_or_path is not None:
        from torchmetrics_tpu_torch.utilities.hf import (
            hf_embedding_forward,
            hf_tokenize,
            load_hf_model_and_tokenizer,
            model_max_length,
        )

        hf_model, hf_tok = load_hf_model_and_tokenizer(model_name_or_path)
        model = hf_embedding_forward(hf_model, num_layers=num_layers)
        pad_width = model_max_length(hf_model, max_length)
        if user_tokenizer is None:
            hf_max_length = pad_width
            user_tokenizer = lambda sents: dict(  # noqa: E731
                zip(("input_ids", "attention_mask"), hf_tokenize(hf_tok, sents, max_length=hf_max_length))
            )
    return model, user_tokenizer, pad_width


def _score_from_tokens(
    pred_tok: Dict[str, Any],
    tgt_tok: Dict[str, Any],
    forward: Callable,
    idf: bool,
    device: Union[str, torch.device],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pair (precision, recall, f1) of tokenized batches on ``device``: the half of
    the pipeline after the tokenizer, shared by the functional and the modular metric."""
    table = (
        _idf_table(_compute_idf([tgt_tok["input_ids"]], [tgt_tok["attention_mask"]]), device) if idf else None
    )

    pred_ids = torch.as_tensor(pred_tok["input_ids"], device=device)
    pred_mask = torch.as_tensor(pred_tok["attention_mask"], device=device)
    tgt_ids = torch.as_tensor(tgt_tok["input_ids"], device=device)
    tgt_mask = torch.as_tensor(tgt_tok["attention_mask"], device=device)

    pred_emb = torch.as_tensor(forward(pred_ids, pred_mask), device=device)
    tgt_emb = torch.as_tensor(forward(tgt_ids, tgt_mask), device=device)
    pred_w = _idf_weights(pred_ids, pred_mask, table)
    tgt_w = _idf_weights(tgt_ids, tgt_mask, table)
    return _greedy_cosine_scores(
        pred_emb, pred_mask.to(torch.float32), tgt_emb, tgt_mask.to(torch.float32), pred_w, tgt_w
    )


def bert_score(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Optional[Callable] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 4,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
) -> Dict[str, Union[torch.Tensor, List[float], str]]:
    """BERTScore of each pair; ``device`` runs the scoring (``None``: the card).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import bert_score
        >>> table = torch.randn(16, 4, generator=torch.Generator().manual_seed(0))
        >>> def tokenizer(sentences):
        ...     ids = torch.tensor([[len(w) for w in s.split()] + [0] * (4 - len(s.split())) for s in sentences])
        ...     return {"input_ids": ids, "attention_mask": (ids > 0).long()}
        >>> out = bert_score(["hello there"], ["hello there"], model=lambda ids, mask: table[ids],
        ...                  user_tokenizer=tokenizer, device="cpu")
        >>> print(round(float(out["f1"][0]), 4))
        1.0
    """
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sentences must be the same!")
    if rescale_with_baseline:
        raise ValueError("Baseline rescaling requires downloadable baseline files, which are unavailable.")
    device = resolve_device(device)
    model, user_tokenizer, _ = _resolve_model_and_tokenizer(model_name_or_path, num_layers, model, user_tokenizer, max_length)
    _validate_model_inputs(model if model is not None else model_name_or_path, user_tokenizer)

    pred_tok = user_tokenizer(preds)
    tgt_tok = user_tokenizer(target)
    forward = user_forward_fn if user_forward_fn is not None else model
    precision, recall, f1 = _score_from_tokens(pred_tok, tgt_tok, forward, idf, device)
    return {"precision": precision, "recall": recall, "f1": f1}
