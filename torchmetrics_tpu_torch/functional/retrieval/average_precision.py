"""Retrieval average precision (counterpart of ``torchmetrics_tpu/functional/retrieval/average_precision.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_average_precision(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """AP of one query: the mean over the relevant documents in the top k of
    (relevant documents up to its rank) / (its rank), 0 when none is relevant.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    top_k = preds.shape[-1] if top_k is None else top_k
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError(f"Argument ``top_k`` has to be a positive integer or None, but got {top_k}.")

    k = min(top_k, preds.shape[-1])
    rel = target[_argsort_descending(preds)][:k].to(torch.float32)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=preds.device)
    j = torch.cumsum(rel, dim=0)
    n_rel = rel.sum()
    ap = torch.sum(rel * j / ranks) / torch.where(n_rel == 0, 1.0, n_rel)
    return torch.where(n_rel == 0, 0.0, ap)
