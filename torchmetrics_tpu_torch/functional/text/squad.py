"""SQuAD exact match and F1 (counterpart of ``torchmetrics_tpu/functional/text/squad.py``).

Host code: each answer is scored in Python floats and the sums reach the states as
Python scalars, with no host-to-device copy.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _device_scalars

SINGLE_PRED_TYPE = Dict[str, Any]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]


def _normalize_text(s: str) -> str:
    """Lowercase; drop punctuation, articles and extra whitespace."""

    def remove_articles(text: str) -> str:
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text: str) -> str:
        return " ".join(text.split())

    def remove_punc(text: str) -> str:
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def _get_tokens(s: str) -> List[str]:
    """Normalized tokens."""
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-overlap F1."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        # if either is no-answer, F1 is 1 if they agree, 0 otherwise
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = 1.0 * num_same / len(predicted_tokens)
    recall = 1.0 * num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    """Exact match after normalization."""
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    """The best score over the ground truths."""
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(
    preds: PREDS_TYPE, targets: TARGETS_TYPE
) -> Tuple[Dict[str, str], List[Dict[str, List[Dict[str, List[Any]]]]]]:
    """Check the keys and bring both inputs to the SQuAD layout."""
    if isinstance(preds, Dict):
        preds = [preds]
    if isinstance(targets, Dict):
        targets = [targets]

    for pred in preds:
        keys = pred.keys()
        if "prediction_text" not in keys or "id" not in keys:
            raise KeyError(f"Expected keys in a single prediction are 'prediction_text' and 'id'. Got {keys}")
    for target in targets:
        keys = target.keys()
        if "answers" not in keys or "id" not in keys:
            raise KeyError(f"Expected keys in a single target are 'answers' and 'id'. Got {keys}")
        answers_keys = target["answers"].keys()
        if "text" not in answers_keys:
            raise KeyError(f"Expected keys in a 'answers' are 'text'. Got {answers_keys}")

    preds_dict = {prediction["id"]: prediction["prediction_text"] for prediction in preds}
    _fn_answer = lambda tgt: {"answers": [{"text": txt} for txt in tgt["answers"]["text"]], "id": tgt["id"]}
    targets_dict = [{"paragraphs": [{"qas": [_fn_answer(target) for target in targets]}]}]
    return preds_dict, targets_dict


def _squad_update(
    preds: Dict[str, str],
    target: List[Dict[str, List[Dict[str, List[Any]]]]],
) -> Tuple[float, float, int]:
    """Σ F1, Σ exact match and the question count, as host numbers."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1: torch.Tensor, exact_match: torch.Tensor, total: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean exact match and F1, in percent."""
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(
    preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Union[str, torch.device]] = None
) -> Dict[str, torch.Tensor]:
    """SQuAD exact match and F1; ``device`` holds the result (``None``: the card).

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import squad
        >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
        >>> out = squad(preds, target, device="cpu")
        >>> print(float(out['exact_match']), float(out['f1']))
        100.0 100.0
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    return _squad_compute(*_device_scalars(device, *_squad_update(preds_dict, target_dict)))
