"""Perplexity (counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``).

The one text metric whose update is device work: ``-log p(target) = logsumexp(logits)
- logits[target]`` in float32, one reduction over the vocabulary and a gather, with no
``(N, V)`` log-probability table. ``ignore_index`` is a ``torch.where`` mask, so the
update reads nothing back and replays under the engine.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_FLOAT_OR_DOUBLE = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _check_shape_and_type_consistency(preds: torch.Tensor, target: torch.Tensor) -> None:
    """``[B, T, V]`` float logits against ``[B, T]`` integer targets."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if preds.shape[:2] != target.shape:
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {preds.shape[:2]} and {target.shape}."
        )
    if preds.dtype not in _FLOAT_OR_DOUBLE:
        raise TypeError(f"Input tensor `preds` is expected to be of floating point type but got {preds.dtype}.")
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {target.dtype}.")


def _perplexity_update(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ -log p(target) (float32) and the int32 count of the tokens that count."""
    _check_shape_and_type_consistency(preds, target)

    logits = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    target = target.reshape(-1)

    if ignore_index is not None:
        mask = target != ignore_index
        target = torch.where(mask, target, 0)
    else:
        mask = torch.ones_like(target, dtype=torch.bool)

    lse = torch.logsumexp(logits, dim=1)
    picked = torch.gather(logits, 1, target[:, None].to(torch.int64)).squeeze(1)
    total_log_probs = torch.sum((lse - picked) * mask)
    count = mask.sum(dtype=torch.int32)
    return total_log_probs, count


def _perplexity_compute(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """exp of the mean negative log-likelihood."""
    return torch.exp(total / count)


def perplexity(preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None) -> torch.Tensor:
    """Perplexity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.text import perplexity
        >>> logits = torch.log(torch.tensor([[[0.5, 0.25, 0.25], [0.25, 0.5, 0.25]]]))
        >>> print(round(float(perplexity(logits, torch.tensor([[0, 1]]))), 2))
        2.0
    """
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
