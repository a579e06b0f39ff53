"""ROUGE (counterpart of ``torchmetrics_tpu/functional/text/rouge.py``).

Host code: tokens, n-gram hits and longest common subsequences are counted on the
CPU. ROUGE-L's LCS length comes from the numpy table; the JAX package's C++ two-row
programme (``native/match.cpp``) has no port counterpart yet and gives the same
integer. ``_rouge_score_compute`` reads every per-sample list to the host in one copy
and takes the means in float64.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+|\n")


def _split_sentence(x: str) -> Sequence[str]:
    """Regex sentence splitter (the JAX package's; no downloaded punkt model)."""
    parts = [s.strip() for s in _SENTENCE_RE.split(x)]
    return [s for s in parts if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    """Precision, recall and F-measure of a hit count, as host floats."""
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": float(precision), "recall": float(recall), "fmeasure": float(fmeasure)}


def _lcs_table(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> np.ndarray:
    """The LCS dynamic-programming table."""
    m, n = len(pred_tokens), len(target_tokens)
    table = np.zeros((m + 1, n + 1), dtype=np.int64)
    for i in range(1, m + 1):
        prev_row = table[i - 1]
        cur = table[i]
        for j in range(1, n + 1):
            if pred_tokens[i - 1] == target_tokens[j - 1]:
                cur[j] = prev_row[j - 1] + 1
            else:
                cur[j] = max(prev_row[j], cur[j - 1])
    return table


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """Length of the longest common subsequence, by the native two-row DP
    (``native/match.cpp:lcs_len``) over local int ids, as the JAX package computes it.
    ROUGE-L needs only the length; ROUGE-Lsum backtracks and keeps ``_lcs_table``."""
    if not pred_tokens or not target_tokens:
        return 0
    from torchmetrics_tpu_torch.native.rle_mask import lcs_len

    ids: dict = {}
    a = np.fromiter((ids.setdefault(t, len(ids)) for t in pred_tokens), np.int64, len(pred_tokens))
    b = np.fromiter((ids.setdefault(t, len(ids)) for t in target_tokens), np.int64, len(target_tokens))
    return lcs_len(a, b)


def _backtracked_lcs(
    lcs_table: np.ndarray, row_tokens: Sequence[str], col_tokens: Sequence[str]
) -> Sequence[int]:
    """Backtrack the LCS table to row-token indices.

    Row orientation and tie-breaking match the official rouge_score
    ``_backtrack_norec`` so ROUGE-Lsum reproduces its hit sets exactly.
    """
    i = len(row_tokens)
    j = len(col_tokens)
    backtracked: List[int] = []
    while i > 0 and j > 0:
        if row_tokens[i - 1] == col_tokens[j - 1]:
            backtracked.insert(0, i - 1)
            i -= 1
            j -= 1
        elif lcs_table[i][j - 1] > lcs_table[i - 1][j]:
            j -= 1
        else:
            i -= 1
    return backtracked


def _union_lcs(pred_tokens_list: Sequence[Sequence[str]], target_tokens: Sequence[str]) -> Sequence[str]:
    """Union of the LCS indices into the target over all predicted sentences.

    The per-pair table rows the target sentence (official rouge_score orientation).
    """
    token_ids: set = set()
    for pred_tokens in pred_tokens_list:
        table = _lcs_table(target_tokens, pred_tokens)
        token_ids.update(_backtracked_lcs(table, target_tokens, pred_tokens))
    return [target_tokens[i] for i in sorted(token_ids)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase, keep alphanumerics, tokenize and optionally stem."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """ROUGE-N precision, recall and F-measure."""

    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    """ROUGE-L precision, recall and F-measure."""
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    lcs = _lcs(pred, target)
    return _compute_metrics(lcs, pred_len, target_len)


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    """ROUGE-Lsum precision, recall and F-measure over the union LCS."""
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    def _get_token_counts(sentences: Sequence[Sequence[str]]) -> Counter:
        ngrams: Counter = Counter()
        for sentence in sentences:
            ngrams.update(sentence)
        return ngrams

    pred_tokens_count = _get_token_counts(pred)
    target_tokens_count = _get_token_counts(target)

    hits = 0
    for tgt in target:
        lcs = _union_lcs(pred, tgt)
        for token in lcs:
            if pred_tokens_count[token] > 0 and target_tokens_count[token] > 0:
                hits += 1
                pred_tokens_count[token] -= 1
                target_tokens_count[token] -= 1

    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sample scores, the best or the mean over each sample's references."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        result_inner: Dict[Union[int, str], Dict[str, float]] = {key: {} for key in rouge_keys_values}
        result_avg: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}
        list_results = []
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        pred_lsum = []
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer) for s in _split_sentence(pred_raw)
            ]

        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            target_lsum = []
            if "Lsum" in rouge_keys_values:
                target_lsum = [
                    _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                    for s in _split_sentence(target_raw_inner)
                ]

            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred, tgt, rouge_key)
                elif rouge_key == "L":
                    score = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    score = _rouge_lsum_score(pred_lsum, target_lsum)
                result_inner[rouge_key] = score
                result_avg[rouge_key].append(score)
            list_results.append(result_inner.copy())

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            all_fmeasure = np.asarray([float(v[key_curr]["fmeasure"]) for v in list_results])
            highest_idx = int(all_fmeasure.argmax())
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        else:  # avg
            for rouge_key in rouge_keys_values:
                scores = result_avg[rouge_key]
                avg = {
                    tp: float(np.mean([float(s[tp]) for s in scores]))
                    for tp in ("precision", "recall", "fmeasure")
                }
                results[rouge_key].append(avg)

    return results


def _rouge_score_compute(
    sentence_results: Dict[str, Union[List[Any], torch.Tensor]], device: Optional[Union[str, torch.device]] = None
) -> Dict[str, torch.Tensor]:
    """The mean of each key's per-sample scores (0 for none).

    A key holds host floats (the functional path), 1-d tensors (one per update) or,
    after a sync, one tensor of every sample. The tensors go to the host in one copy,
    the means come back in one.
    """
    tensors = [
        torch.atleast_1d(s).reshape(-1)
        for scores in sentence_results.values()
        for s in (scores if isinstance(scores, list) else [scores])
        if isinstance(s, torch.Tensor)
    ]
    if tensors:
        device = tensors[0].device
        host = iter(np.split(torch.cat(tensors).cpu().double().numpy(), np.cumsum([t.numel() for t in tensors])[:-1]))
    means = []
    for scores in sentence_results.values():
        parts = [
            next(host) if isinstance(s, torch.Tensor) else np.atleast_1d(np.asarray(s, dtype=np.float64))
            for s in (scores if isinstance(scores, list) else [scores])
        ]
        flat = np.concatenate(parts) if parts else np.zeros(0)
        means.append(float(np.mean(flat)) if flat.size else 0.0)
    values = torch.tensor(means, dtype=torch.float32, device=resolve_device(device))
    return dict(zip(sentence_results, values.unbind()))


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """ROUGE; ``device`` holds the result (``None``: the card).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import rouge_score
        >>> out = rouge_score("the cat sat on the mat", "a cat sat on the mat", device="cpu")
        >>> print(round(float(out["rouge1_fmeasure"]), 4))
        0.8333
    """
    stemmer = None
    if use_stemmer:
        try:
            from nltk.stem.porter import PorterStemmer
        except ImportError as err:
            raise ModuleNotFoundError(
                "Stemmer support requires `nltk` which is not installed; pass `use_stemmer=False`"
                " or supply pre-stemmed text via a custom `normalizer`."
            ) from err
        stemmer = PorterStemmer()

    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )

    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    sentence_results = _rouge_score_update(preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer)

    output: Dict[str, List[float]] = {
        f"rouge{rouge_key}_{tp}": [] for rouge_key in rouge_keys_values for tp in ("fmeasure", "precision", "recall")
    }
    for rouge_key, metrics in sentence_results.items():
        for metric in metrics:
            for tp, value in metric.items():
                output[f"rouge{rouge_key}_{tp}"].append(value)

    return _rouge_score_compute(output, device)
