"""Match error rate (counterpart of ``torchmetrics_tpu/functional/text/mer.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _device_scalars, _edit_distance


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Σ edit operations and Σ max(reference length, prediction length), as host floats."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    return float(errors), float(total)


def _mer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Match error rate; ``device`` holds the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.mer import match_error_rate
        >>> print(round(float(match_error_rate(preds, target, device="cpu")), 4))
        0.2222
    """
    return _mer_compute(*_device_scalars(device, *_mer_update(preds, target)))
