"""``RetrievalNormalizedDCG`` (counterpart of ``torchmetrics_tpu/retrieval/ndcg.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalNormalizedDCG(RetrievalMetric):
    """nDCG@k per query with graded relevance, over the dense rank matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        0.9599
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
        self.allow_non_binary_target = True

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        max_len = target_mat.shape[-1]
        k = min(self.top_k, max_len) if self.top_k is not None else max_len
        positions = torch.arange(max_len, device=target_mat.device)
        discount = 1.0 / torch.log2(positions + 2.0)
        dcg = (target_mat * self._in_topk(valid) * discount).sum(dim=-1)
        ideal = -torch.sort(-(target_mat * valid), dim=-1).values
        idcg = (ideal * (positions < k) * discount).sum(dim=-1)
        return torch.where(idcg == 0, 0.0, dcg / torch.where(idcg == 0, 1.0, idcg))
