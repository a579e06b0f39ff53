"""Edit-distance core of the text metrics (counterpart of
``torchmetrics_tpu/functional/text/helper.py``).

Host code, as in the JAX package: tokens and the dynamic programme over ragged
sequences stay on the CPU, and only the summed counters reach device states. Each row
of the Levenshtein recurrence is a few numpy operations: the in-row dependency
``dp[j] = min(dp[j-1] + 1, ...)`` is a min-plus prefix scan,
``min.accumulate(candidate - j) + j``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device


def _token_ids(tokens: Sequence[str], vocab: dict) -> np.ndarray:
    """Integer codes of ``tokens`` (``vocab`` grows in place)."""
    return np.asarray([vocab.setdefault(t, len(vocab)) for t in tokens], dtype=np.int64)


def _edit_distance(prediction_tokens: Sequence[str], reference_tokens: Sequence[str]) -> int:
    """Levenshtein distance between two token sequences."""
    if len(prediction_tokens) == 0:
        return len(reference_tokens)
    if len(reference_tokens) == 0:
        return len(prediction_tokens)
    vocab: dict = {}
    a = _token_ids(prediction_tokens, vocab)
    b = _token_ids(reference_tokens, vocab)

    n = b.shape[0]
    j_range = np.arange(n + 1)
    prev = j_range.copy()
    for i, ca in enumerate(a, start=1):
        cost = (b != ca).astype(np.int64)
        m = np.empty(n + 1, dtype=np.int64)
        m[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + cost, out=m[1:])
        # the deletion chain dp[j] = min_{k<=j} m[k] + (j - k): a min-plus prefix scan
        prev = np.minimum.accumulate(m - j_range) + j_range
    return int(prev[-1])


def _device_scalars(device: Optional[Union[str, torch.device]], *values: float) -> Tuple[torch.Tensor, ...]:
    """Host counters as float32 0-d tensors on ``device`` (``None``: the card), in one copy."""
    return torch.tensor(values, dtype=torch.float32, device=resolve_device(device)).unbind()
