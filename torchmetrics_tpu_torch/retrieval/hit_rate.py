"""``RetrievalHitRate`` (counterpart of ``torchmetrics_tpu/retrieval/hit_rate.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalHitRate(RetrievalMetric):
    """The share of queries with a relevant document in the top k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalHitRate(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.top_k = self._validate_top_k(top_k)

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        return ((target_mat * self._in_topk(valid)).sum(dim=-1) > 0).to(torch.float32)
