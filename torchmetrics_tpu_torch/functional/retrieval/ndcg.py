"""Retrieval normalized DCG (counterpart of ``torchmetrics_tpu/functional/retrieval/ndcg.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def _dcg(target: torch.Tensor) -> torch.Tensor:
    """Discounted cumulative gain along the last axis."""
    denom = torch.log2(torch.arange(target.shape[-1], device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """nDCG of one query; graded relevance is allowed.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        0.9197
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)

    top_k = preds.shape[-1] if top_k is None else top_k
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")

    k = min(top_k, preds.shape[-1])
    sorted_target = target[_argsort_descending(preds)][:k].to(torch.float32)
    ideal_target = -torch.sort(-target.to(torch.float32)).values[:k]

    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return torch.where(ideal_dcg == 0, 0.0, target_dcg / torch.where(ideal_dcg == 0, 1.0, ideal_dcg))
