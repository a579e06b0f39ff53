"""Translation edit rate (counterpart of ``torchmetrics_tpu/functional/text/ter.py``).

Host code: tercom's shift search with an exact Levenshtein distance, as in the JAX
package (its heuristics, candidate ranking and limits are kept, so the scores are the
same). A shift candidate needs only its distance, which the numpy row scan of
``helper._edit_distance`` gives; the operation trace is built once per round. Only the
summed counters reach the device, as Python scalars; sentence scores are 1-element
tensors, one host-to-device copy per sentence.
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance
from torchmetrics_tpu_torch.metric import resolve_device

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# edit ops, single-char codes: n(othing) s(ubstitute) i(nsert) d(elete)
_OP_N, _OP_S, _OP_I, _OP_D = "n", "s", "i", "d"


class _TercomTokenizer:
    """The tercom normalizer."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)  # noqa: B019
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    """Tokenize one sentence."""
    return tokenizer(sentence.rstrip())


def _edit_distance_with_trace(prediction_tokens: List[str], reference_tokens: List[str]) -> Tuple[int, str]:
    """Exact Levenshtein distance + operations trace, tercom op preference.

    Preference when costs tie: substitute/nothing, then delete, then insert
    (tercom's order, swapped for the later flip).
    """
    p_len, r_len = len(prediction_tokens), len(reference_tokens)
    cost = np.zeros((p_len + 1, r_len + 1), dtype=np.int64)
    op = np.empty((p_len + 1, r_len + 1), dtype="<U1")
    cost[:, 0] = np.arange(p_len + 1)
    cost[0, :] = np.arange(r_len + 1)
    op[:, 0] = _OP_D
    op[0, :] = _OP_I
    op[0, 0] = ""
    for i in range(1, p_len + 1):
        for j in range(1, r_len + 1):
            if prediction_tokens[i - 1] == reference_tokens[j - 1]:
                sub_cost, sub_op = cost[i - 1, j - 1], _OP_N
            else:
                sub_cost, sub_op = cost[i - 1, j - 1] + 1, _OP_S
            best_cost, best_op = sub_cost, sub_op
            if cost[i - 1, j] + 1 < best_cost:
                best_cost, best_op = cost[i - 1, j] + 1, _OP_D
            if cost[i, j - 1] + 1 < best_cost:
                best_cost, best_op = cost[i, j - 1] + 1, _OP_I
            cost[i, j] = best_cost
            op[i, j] = best_op

    trace = []
    i, j = p_len, r_len
    while i > 0 or j > 0:
        operation = op[i, j]
        trace.append(operation)
        if operation in (_OP_N, _OP_S):
            i -= 1
            j -= 1
        elif operation == _OP_I:
            j -= 1
        else:  # delete
            i -= 1
    return int(cost[-1, -1]), "".join(reversed(trace))


def _flip_trace(trace: str) -> str:
    """Swap insertions and deletions: the recipe for rewriting b into a."""
    table = str.maketrans({_OP_I: _OP_D, _OP_D: _OP_I})
    return trace.translate(table)


def _trace_to_alignment(trace: str) -> Tuple[Dict[int, int], List[int], List[int]]:
    """The alignment and per-position error flags of a trace."""
    reference_position = hypothesis_position = -1
    reference_errors: List[int] = []
    hypothesis_errors: List[int] = []
    alignments: Dict[int, int] = {}
    for operation in trace:
        if operation == _OP_N:
            hypothesis_position += 1
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(0)
            hypothesis_errors.append(0)
        elif operation == _OP_S:
            hypothesis_position += 1
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(1)
            hypothesis_errors.append(1)
        elif operation == _OP_I:
            hypothesis_position += 1
            hypothesis_errors.append(1)
        elif operation == _OP_D:
            reference_position += 1
            alignments[reference_position] = hypothesis_position
            reference_errors.append(1)
        else:
            raise ValueError(f"Unknown operation {operation!r}")
    return alignments, reference_errors, hypothesis_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Matching word sub-sequences at different positions."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if (
                    pred_start + length > len(pred_words)
                    or target_start + length > len(target_words)
                    or pred_words[pred_start + length - 1] != target_words[target_start + length - 1]
                ):
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _handle_corner_cases_during_shifting(
    alignments: Dict[int, int],
    pred_errors: List[int],
    target_errors: List[int],
    pred_start: int,
    target_start: int,
    length: int,
) -> bool:
    """The corner cases that prune a shift."""
    if sum(pred_errors[pred_start : pred_start + length]) == 0:
        return True
    if sum(target_errors[target_start : target_start + length]) == 0:
        return True
    if pred_start <= alignments[target_start] < pred_start + length:
        return True
    return False


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` to position ``target``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]
    )


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    reference_tokens: List[str],
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of the best-shift search; a candidate is scored by its edit distance alone."""
    edit_distance, inverted_trace = _edit_distance_with_trace(pred_words, reference_tokens)
    trace = _flip_trace(inverted_trace)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        if _handle_corner_cases_during_shifting(
            alignments, pred_errors, target_errors, pred_start, target_start, length
        ):
            continue
        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - _edit_distance(shifted_words, reference_tokens),
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> int:
    """The edits, shifts included, that match one hypothesis to one reference."""
    if len(target_words) == 0:
        return 0

    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, target_words, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words

    edit_distance, _ = _edit_distance_with_trace(input_words, target_words)
    return num_shifts + edit_distance


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """The fewest edits over the references and the mean reference length."""
    tgt_lengths = 0.0
    best_num_edits = 2e16
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words)
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: torch.Tensor, tgt_length: torch.Tensor) -> torch.Tensor:
    """TER = edits / mean reference length, on the device."""
    return torch.where(
        (tgt_length > 0) & (num_edits > 0),
        num_edits / torch.where(tgt_length > 0, tgt_length, 1.0),
        torch.where((tgt_length == 0) & (num_edits > 0), 1.0, 0.0),
    )


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: torch.Tensor,
    total_tgt_length: torch.Tensor,
    sentence_ter: Optional[List[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[torch.Tensor]]]:
    """The summed states after one batch (and the sentence scores appended)."""
    if isinstance(preds, str):
        preds = [preds]
    target_: Sequence[Sequence[str]] = [[t] if isinstance(t, str) else t for t in target]

    edits_add = 0.0
    length_add = 0.0
    for pred, tgt in zip(preds, target_):
        tgt_words_ = [_preprocess_sentence(_tgt, tokenizer).split() for _tgt in tgt]
        pred_words_ = _preprocess_sentence(pred, tokenizer).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        edits_add += num_edits
        length_add += tgt_length
        if sentence_ter is not None:
            # scored on the host, then one copy: a 1-element tensor per sentence
            score = _compute_ter_score_from_statistics(torch.tensor([float(num_edits)]), torch.tensor([tgt_length]))
            sentence_ter.append(score.to(total_num_edits.device))
    return total_num_edits + edits_add, total_tgt_length + length_add, sentence_ter


def _ter_compute(total_num_edits: torch.Tensor, total_tgt_length: torch.Tensor) -> torch.Tensor:
    """Corpus TER."""
    return _compute_ter_score_from_statistics(total_num_edits, total_tgt_length)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Translation edit rate; ``device`` holds the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate
        >>> print(round(float(translation_edit_rate(preds, target, device="cpu")), 4))
        0.2222
    """
    if not isinstance(normalize, bool):
        raise ValueError(f"Expected argument `normalize` to be of type boolean but got {normalize}.")
    if not isinstance(no_punctuation, bool):
        raise ValueError(f"Expected argument `no_punctuation` to be of type boolean but got {no_punctuation}.")
    if not isinstance(lowercase, bool):
        raise ValueError(f"Expected argument `lowercase` to be of type boolean but got {lowercase}.")
    if not isinstance(asian_support, bool):
        raise ValueError(f"Expected argument `asian_support` to be of type boolean but got {asian_support}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    zeros = torch.zeros(2, device=resolve_device(device))
    sentence_ter: Optional[List[torch.Tensor]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(
        preds, target, tokenizer, zeros[0], zeros[1], sentence_ter
    )
    ter = _ter_compute(total_num_edits, total_tgt_length)
    if sentence_ter is not None:
        return ter, torch.cat(sentence_ter)
    return ter
