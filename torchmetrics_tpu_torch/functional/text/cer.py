"""Character error rate (counterpart of ``torchmetrics_tpu/functional/text/cer.py``)."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _device_scalars, _edit_distance


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[float, float]:
    """Σ character edit operations and Σ reference characters, as host floats."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = list(pred)
        tgt_tokens = list(tgt)
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += len(tgt_tokens)
    return float(errors), float(total)


def _cer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Union[str, torch.device]] = None
) -> torch.Tensor:
    """Character error rate; ``device`` holds the result (``None``: the card).

    Example:
        >>> preds = ['the cat sat on the mat', 'hello world']
        >>> target = ['the cat sat on a mat', 'hello there world']
        >>> from torchmetrics_tpu_torch.functional.text.cer import char_error_rate
        >>> print(round(float(char_error_rate(preds, target, device="cpu")), 4))
        0.2432
    """
    return _cer_compute(*_device_scalars(device, *_cer_update(preds, target)))
