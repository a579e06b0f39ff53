"""Retrieval precision-recall curve (counterpart of
``torchmetrics_tpu/functional/retrieval/precision_recall_curve.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_precision_recall_curve(
    preds: torch.Tensor, target: torch.Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision@k and recall@k of one query for every k in [1, max_k], and the ks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> precision, recall, top_k = retrieval_precision_recall_curve(preds, target, max_k=2)
        >>> precision.tolist(), recall.tolist(), top_k.tolist()
        ([1.0, 0.5], [0.5, 0.5], [1, 2])
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    if max_k is None:
        max_k = preds.shape[-1]
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")

    n = preds.shape[-1]
    topk = torch.arange(1, max_k + 1, device=preds.device)
    if adaptive_k and max_k > n:
        topk = topk.clamp(max=n)

    relevant = target[_argsort_descending(preds)][: min(max_k, n)].to(torch.float32)
    relevant = torch.nn.functional.pad(relevant, (0, max(0, max_k - relevant.shape[0])))
    relevant = torch.cumsum(relevant, dim=0)

    n_pos = target.sum()
    recall = torch.where(n_pos == 0, 0.0, relevant / torch.where(n_pos == 0, 1, n_pos))
    precision = torch.where(n_pos == 0, 0.0, relevant / topk)
    return precision, recall, topk
