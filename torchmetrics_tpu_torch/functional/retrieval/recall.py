"""Retrieval recall (counterpart of ``torchmetrics_tpu/functional/retrieval/recall.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_recall(preds: torch.Tensor, target: torch.Tensor, top_k: Optional[int] = None) -> torch.Tensor:
    """The share of the relevant documents retrieved in the top k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_recall(preds, target)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    if top_k is None:
        top_k = preds.shape[-1]
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")

    n_pos = target.sum()
    relevant = target[_argsort_descending(preds)][:top_k].sum().to(torch.float32)
    return torch.where(n_pos == 0, 0.0, relevant / torch.where(n_pos == 0, 1, n_pos))
