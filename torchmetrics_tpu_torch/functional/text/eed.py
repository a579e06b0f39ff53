"""Extended edit distance (counterpart of ``torchmetrics_tpu/functional/text/eed.py``).

Host code: a CDER-style character dynamic programme with jump and coverage costs, each
row a few numpy operations (the deletion chain ``next[i] = min(next[i-1] + del, ...)``
is the min-plus prefix scan ``min.accumulate(m - i * del) + i * del``). The sentence
scores are host floats; the modular metric keeps one 1-element tensor per sentence,
the JAX package's list layout (one host-to-device copy each).
"""

from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.validate import _validate_inputs
from torchmetrics_tpu_torch.metric import resolve_device


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Extended edit distance of one sentence pair."""
    n = len(hyp)
    number_of_visits = np.full(n + 1, -1, dtype=np.int64)
    row = np.ones(n + 1)
    row[0] = 0.0  # CDER initialisation
    hyp_chars = np.asarray([ord(c) for c in hyp], dtype=np.int64) if n else np.zeros(0, dtype=np.int64)
    i_del = np.arange(n + 1) * deletion

    for w in range(1, len(ref) + 1):
        dist = (hyp_chars != ord(ref[w - 1])).astype(np.float64) if n else np.zeros(0)
        m = np.empty(n + 1)
        m[0] = row[0] + 1.0
        if n:
            np.minimum(row[:-1] + dist, row[1:] + insertion, out=m[1:])
        # deletion chain: next[i] = min_{k<=i} m[k] + (i-k)*deletion
        next_row = np.minimum.accumulate(m - i_del) + i_del

        min_index = int(next_row.argmin())
        number_of_visits[min_index] += 1

        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = np.minimum(next_row, jump)
        row = next_row

    coverage = rho * np.where(number_of_visits >= 0, number_of_visits, 1).sum()
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    rules_re = [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]
    for pattern, replacement in rules_re:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _preprocess_sentences(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str,
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    """Validate the corpora and apply the language's preprocessing."""
    target, preds = _validate_inputs(hypothesis_corpus=preds, ref_corpus=target)
    if language == "en":
        preprocess_function = _preprocess_en
    elif language == "ja":
        preprocess_function = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    preds = [preprocess_function(pred) for pred in preds]
    target = [[preprocess_function(ref) for ref in reference] for reference in target]
    return preds, target


def _compute_sentence_statistics(
    preds_word: str,
    target_words: Union[str, Sequence[str]],
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """The best (lowest) score over the references."""
    best_score = inf
    for reference in target_words:
        score = _eed_function(preds_word, reference, alpha, rho, deletion, insertion)
        if score < best_score:
            best_score = score
    return best_score


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Append the sentence scores of one batch, as host floats."""
    preds, target = _preprocess_sentences(preds, target, language)
    if sentence_eed is None:
        sentence_eed = []
    if 0 in (len(preds), len(target[0])):
        return sentence_eed
    for hypothesis, target_words in zip(preds, target):
        sentence_eed.append(_compute_sentence_statistics(hypothesis, target_words, alpha, rho, deletion, insertion))
    return sentence_eed


def _eed_compute(sentence_level_scores: torch.Tensor) -> torch.Tensor:
    """The mean of the sentence scores (0 for none)."""
    if sentence_level_scores.numel() == 0:
        return sentence_level_scores.new_zeros(())
    return sentence_level_scores.sum() / sentence_level_scores.numel()


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Extended edit distance; ``device`` holds the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance
        >>> print(round(float(extended_edit_distance(preds, target, device="cpu")), 4))
        0.2456
    """
    for param_name, param in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")

    scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    sentence_level_scores = torch.tensor(scores, dtype=torch.float32, device=resolve_device(device))
    average = _eed_compute(sentence_level_scores)
    if return_sentence_level_score:
        return average, sentence_level_scores
    return average
