"""chrF and chrF++ (counterpart of ``torchmetrics_tpu/functional/text/chrf.py``).

Each statistic is one fixed-shape float32 sum state indexed by n-gram order:
``(n_char_order,)`` and ``(n_word_order,)``. An update counts on the host and adds the
six per-order vectors in one host-to-device copy; with sentence-level scores it also
appends one 0-d tensor per sentence (one copy each), the JAX package's list layout.
``compute`` reads the six states to the host once and scores in float64.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """The character stream, whitespace dropped unless ``whitespace``."""
    if whitespace:
        return list(sentence)
    return list("".join(sentence.split()))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split one leading or trailing punctuation mark off a word."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """Words with their punctuation separated."""
    return sum((_separate_word_and_punctuation(word) for word in sentence.strip().split()), [])


def _ngram_counts(char_or_word_list: List[str], n_gram_order: int) -> Dict[int, Counter]:
    """Counters of the n-grams of each order 1..n."""
    ngrams: Dict[int, Counter] = {}
    for n in range(1, n_gram_order + 1):
        ngrams[n] = Counter(tuple(char_or_word_list[i : i + n]) for i in range(len(char_or_word_list) - n + 1))
    return ngrams


def _sentence_statistics(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter], np.ndarray, np.ndarray]:
    """Character and word n-gram counts with their per-order totals."""
    if lowercase:
        sentence = sentence.lower()
    char_n_grams = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_n_grams = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    char_totals = np.asarray([sum(char_n_grams[n].values()) for n in range(1, n_char_order + 1)], dtype=np.float64)
    word_totals = np.asarray([sum(word_n_grams[n].values()) for n in range(1, n_word_order + 1)], dtype=np.float64)
    return char_n_grams, word_n_grams, char_totals, word_totals


def _matches(hyp: Dict[int, Counter], ref: Dict[int, Counter]) -> np.ndarray:
    """Clipped match counts per order."""
    return np.asarray([sum((hyp[n] & ref[n]).values()) for n in sorted(hyp)], dtype=np.float64)


def _fscore_from_arrays(
    matching_char: np.ndarray,
    matching_word: np.ndarray,
    hyp_char: np.ndarray,
    hyp_word: np.ndarray,
    ref_char: np.ndarray,
    ref_word: np.ndarray,
    n_order: float,
    beta: float,
) -> float:
    """The chrF score of per-order totals, in float64."""

    def _f(matching, hyp, ref):
        precision = np.where(hyp > 0, matching / np.where(hyp > 0, hyp, 1.0), 0.0)
        recall = np.where(ref > 0, matching / np.where(ref > 0, ref, 1.0), 0.0)
        denom = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denom

    return float((_f(matching_char, hyp_char, ref_char).sum() + _f(matching_word, hyp_word, ref_word).sum()) / n_order)


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    total_preds_char_n_grams: torch.Tensor,
    total_preds_word_n_grams: torch.Tensor,
    total_target_char_n_grams: torch.Tensor,
    total_target_word_n_grams: torch.Tensor,
    total_matching_char_n_grams: torch.Tensor,
    total_matching_word_n_grams: torch.Tensor,
    n_char_order: int,
    n_word_order: int,
    n_order: float,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_chrf_score: Optional[List[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Optional[List[torch.Tensor]]]:
    """The six states after one batch of corpora (and the sentence scores appended)."""
    if isinstance(preds, str):
        preds = [preds]
    target_: Sequence[Sequence[str]] = [[t] if isinstance(t, str) else t for t in target]
    device = total_preds_char_n_grams.device

    p_char_add = np.zeros(n_char_order)
    p_word_add = np.zeros(n_word_order)
    t_char_add = np.zeros(n_char_order)
    t_word_add = np.zeros(n_word_order)
    m_char_add = np.zeros(n_char_order)
    m_word_add = np.zeros(n_word_order)

    for pred, targets in zip(preds, target_):
        pred_char_counts, pred_word_counts, pred_char_totals, pred_word_totals = _sentence_statistics(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        p_char_add += pred_char_totals
        p_word_add += pred_word_totals

        # start below any attainable f-score, so that the first reference's statistics
        # are recorded even at zero overlap (else its totals vanish from the recall)
        best_f_score = -1.0
        best_matching_char = np.zeros(n_char_order)
        best_matching_word = np.zeros(n_word_order)
        best_target_char = np.zeros(n_char_order)
        best_target_word = np.zeros(n_word_order)

        for tgt in targets:
            tgt_char_counts, tgt_word_counts, tgt_char_totals, tgt_word_totals = _sentence_statistics(
                tgt, n_char_order, n_word_order, lowercase, whitespace
            )
            matching_char = _matches(pred_char_counts, tgt_char_counts)
            matching_word = _matches(pred_word_counts, tgt_word_counts)
            f_score = _fscore_from_arrays(
                matching_char, matching_word, pred_char_totals, pred_word_totals,
                tgt_char_totals, tgt_word_totals, n_order, beta,
            )
            if f_score > best_f_score:
                best_f_score = f_score
                best_matching_char = matching_char
                best_matching_word = matching_word
                best_target_char = tgt_char_totals
                best_target_word = tgt_word_totals

        t_char_add += best_target_char
        t_word_add += best_target_word
        m_char_add += best_matching_char
        m_word_add += best_matching_word
        if sentence_chrf_score is not None:
            sentence_chrf_score.append(torch.tensor(best_f_score, dtype=torch.float32, device=device))

    adds = torch.from_numpy(np.concatenate([p_char_add, p_word_add, t_char_add, t_word_add, m_char_add, m_word_add]))
    adds = adds.to(device=device, dtype=total_preds_char_n_grams.dtype)
    c, w = n_char_order, n_word_order
    return (
        total_preds_char_n_grams + adds[:c],
        total_preds_word_n_grams + adds[c : c + w],
        total_target_char_n_grams + adds[c + w : 2 * c + w],
        total_target_word_n_grams + adds[2 * c + w : 2 * c + 2 * w],
        total_matching_char_n_grams + adds[2 * c + 2 * w : 3 * c + 2 * w],
        total_matching_word_n_grams + adds[3 * c + 2 * w :],
        sentence_chrf_score,
    )


def _chrf_score_compute(
    total_preds_char_n_grams: torch.Tensor,
    total_preds_word_n_grams: torch.Tensor,
    total_target_char_n_grams: torch.Tensor,
    total_target_word_n_grams: torch.Tensor,
    total_matching_char_n_grams: torch.Tensor,
    total_matching_word_n_grams: torch.Tensor,
    n_order: float,
    beta: float,
) -> torch.Tensor:
    """Corpus chrF: the six states read to the host in one copy, scored in float64."""
    states = (
        total_matching_char_n_grams, total_matching_word_n_grams, total_preds_char_n_grams,
        total_preds_word_n_grams, total_target_char_n_grams, total_target_word_n_grams,
    )
    host = torch.cat([s.reshape(-1) for s in states]).cpu().double().numpy()
    parts = np.split(host, np.cumsum([s.numel() for s in states])[:-1])
    score = _fscore_from_arrays(*parts, n_order, beta)
    return torch.tensor(score, dtype=torch.float32, device=total_preds_char_n_grams.device)


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """chrF / chrF++; ``device`` holds the states and the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.chrf import chrf_score
        >>> print(round(float(chrf_score(preds, target, device="cpu")), 4))
        0.5819
    """
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")
    n_order = float(n_char_order + n_word_order)

    device = resolve_device(device)
    states = [torch.zeros(n, device=device) for n in (n_char_order, n_word_order) * 3]
    sentence_scores: Optional[List[torch.Tensor]] = [] if return_sentence_level_score else None
    *states, sentence_scores = _chrf_score_update(
        preds, target, *states, n_char_order, n_word_order, n_order, beta, lowercase, whitespace, sentence_scores
    )
    score = _chrf_score_compute(*states, n_order, beta)
    if sentence_scores is not None:
        return score, torch.stack(sentence_scores)
    return score
