"""Retrieval precision (counterpart of ``torchmetrics_tpu/functional/retrieval/precision.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_precision(
    preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> torch.Tensor:
    """The share of the top k documents that are relevant; ``adaptive_k`` caps k at the
    number of documents.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_precision(preds, target)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if top_k is None or (adaptive_k and top_k > preds.shape[-1]):
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")

    relevant = target[_argsort_descending(preds)][: min(top_k, preds.shape[-1])].sum().to(torch.float32)
    return torch.where(target.sum() == 0, 0.0, relevant / top_k)
