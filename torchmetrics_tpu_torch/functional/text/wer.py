"""Word error rate (counterpart of ``torchmetrics_tpu/functional/text/wer.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _device_scalars, _edit_distance


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Σ edit operations and Σ reference words, as host floats."""
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
        total += len(tgt_tokens)
    return float(errors), float(total)


def _wer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Word error rate; ``device`` holds the result (``None``: the card).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_error_rate
        >>> preds = ['this is the prediction', 'there is an other sample']
        >>> target = ['this is the reference', 'there is another one']
        >>> print(float(word_error_rate(preds, target, device="cpu")))
        0.5
    """
    return _wer_compute(*_device_scalars(device, *_wer_update(preds, target)))
