"""``RetrievalPrecision`` (counterpart of ``torchmetrics_tpu/retrieval/precision.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalPrecision(RetrievalMetric):
    """Precision@k per query, averaged; ``adaptive_k`` caps k at each query's documents.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.4167
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        adaptive_k: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.top_k = self._validate_top_k(top_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        n_valid = valid.sum(dim=-1)
        if self.top_k is None:
            k_den = n_valid.to(torch.float32)
        elif self.adaptive_k:
            k_den = n_valid.clamp(max=self.top_k).to(torch.float32)
        else:
            k_den = torch.full(n_valid.shape, float(self.top_k), device=valid.device)
        relevant = (target_mat * self._in_topk(valid)).sum(dim=-1)
        return relevant / k_den
