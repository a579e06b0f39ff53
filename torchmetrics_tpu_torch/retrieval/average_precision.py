"""``RetrievalMAP`` (counterpart of ``torchmetrics_tpu/retrieval/average_precision.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries, over the dense rank matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> round(float(rmap(preds, target, indexes=indexes)), 4)
        0.7917
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
        ranks = torch.arange(1, target_mat.shape[-1] + 1, dtype=torch.float32, device=target_mat.device)
        rel = target_mat * self._in_topk(valid)
        j = torch.cumsum(rel, dim=-1)
        n_rel = rel.sum(dim=-1)
        ap = torch.sum(rel * j / ranks, dim=-1) / torch.where(n_rel == 0, 1.0, n_rel)
        return torch.where(n_rel == 0, 0.0, ap)
