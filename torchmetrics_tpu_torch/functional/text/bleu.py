"""BLEU (counterpart of ``torchmetrics_tpu/functional/text/bleu.py``).

N-grams are counted on the host; the per-order numerator and denominator are
``(n_gram,)`` float32 sum states, and the geometric mean with its brevity penalty is
computed on the device with ``torch.where`` (no host read).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import resolve_device


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Counter over all 1..n grams."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenizer."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    preds_len: torch.Tensor,
    target_len: torch.Tensor,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The four states after one batch of corpora: the per-order counts arrive in one
    host-to-device copy, the lengths as Python scalars."""
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]

    num_add = [0.0] * n_gram
    den_add = [0.0] * n_gram
    preds_len_add = 0.0
    target_len_add = 0.0
    for pred, targets in zip(preds_tok, target_tok):
        preds_len_add += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len_add += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter: Counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)

        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            num_add[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            den_add[len(counter) - 1] += preds_counter[counter]

    counts = torch.tensor([num_add, den_add], dtype=numerator.dtype, device=numerator.device)
    return numerator + counts[0], denominator + counts[1], preds_len + preds_len_add, target_len + target_len_add


def _bleu_score_compute(
    preds_len: torch.Tensor,
    target_len: torch.Tensor,
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> torch.Tensor:
    """Weighted log precisions with the brevity penalty, on the device."""
    min_numerator = torch.min(numerator)
    denominator_safe = torch.where(denominator == 0, 1.0, denominator)
    if smooth:
        precision_scores = (numerator + 1.0) / (denominator + 1.0)
        precision_scores = torch.cat([(numerator[:1] / denominator_safe[:1]), precision_scores[1:]])
    else:
        precision_scores = numerator / denominator_safe

    precision_safe = torch.where(precision_scores > 0, precision_scores, 1.0)
    # the weights stay Python scalars: a weight tensor would be a host-to-device copy
    # inside the engine's captured compute
    log_precision = torch.log(precision_safe)
    geometric_mean = torch.exp(torch.stack([w * log_precision[i] for i, w in enumerate(weights)]).sum())
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - (target_len / preds_len)))
    return torch.where(min_numerator == 0, 0.0, brevity_penalty * geometric_mean)


def _bleu_states(n_gram: int, device: Optional[Union[str, torch.device]]) -> Tuple[torch.Tensor, ...]:
    """Zeroed ``numerator, denominator, preds_len, target_len`` on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    zeros = torch.zeros(2 * n_gram + 2, device=device)
    return zeros[:n_gram], zeros[n_gram : 2 * n_gram], zeros[-2], zeros[-1]


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """BLEU; ``device`` holds the states and the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.bleu import bleu_score
        >>> print(round(float(bleu_score(preds, target, device="cpu")), 4))
        0.4586
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram

    numerator, denominator, preds_len, target_len = _bleu_score_update(
        preds_, target_, *_bleu_states(n_gram, device), n_gram
    )
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, weights, smooth)
