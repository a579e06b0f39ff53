"""Word information lost (counterpart of ``torchmetrics_tpu/functional/text/wil.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _device_scalars, _edit_distance


def _wil_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float, float]:
    """(Σ edits − Σ max lengths, Σ reference words, Σ predicted words), as host floats."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    total = 0
    errors = 0
    target_total = 0
    preds_total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        target_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, target_tokens)
        target_total += len(target_tokens)
        preds_total += len(pred_tokens)
        total += max(len(target_tokens), len(pred_tokens))
    return float(errors - total), float(target_total), float(preds_total)


def _wil_compute(errors: torch.Tensor, target_total: torch.Tensor, preds_total: torch.Tensor) -> torch.Tensor:
    return 1 - ((errors / target_total) * (errors / preds_total))


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Word information lost; ``device`` holds the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.wil import word_information_lost
        >>> print(round(float(word_information_lost(preds, target, device="cpu")), 4))
        0.3194
    """
    return _wil_compute(*_device_scalars(device, *_wil_update(preds, target)))
