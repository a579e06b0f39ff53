"""``RetrievalRPrecision`` (counterpart of ``torchmetrics_tpu/retrieval/r_precision.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalRPrecision(RetrievalMetric):
    """Precision at rank R, R each query's relevant count, as a mask over the ranks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.75
    """

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        ranks = torch.arange(1, target_mat.shape[-1] + 1, device=target_mat.device)
        n_rel = (target_mat * valid).sum(dim=-1, keepdim=True)
        hit = (target_mat * ((ranks <= n_rel) & valid)).sum(dim=-1)
        n_rel = n_rel.squeeze(-1)
        return torch.where(n_rel == 0, 0.0, hit / torch.where(n_rel == 0, 1.0, n_rel))
