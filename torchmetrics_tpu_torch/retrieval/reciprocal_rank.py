"""``RetrievalMRR`` (counterpart of ``torchmetrics_tpu/retrieval/reciprocal_rank.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank: ``argmax`` over each rank-sorted row finds its first hit.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> round(float(mrr(preds, target, indexes=indexes)), 4)
        0.75
    """

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        rel = target_mat * valid
        return torch.where(rel.sum(dim=-1) > 0, 1.0 / (_first_hit(rel) + 1.0), 0.0)


def _first_hit(rel: torch.Tensor) -> torch.Tensor:
    """The first column of each row with positive relevance (0 for a row with none).
    ``torch.argmax`` rejects bool, so the mask goes in as uint8; it returns the first
    maximal index, as ``jnp.argmax`` does."""
    return torch.argmax((rel > 0).to(torch.uint8), dim=-1)
