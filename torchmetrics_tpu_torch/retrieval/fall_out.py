"""``RetrievalFallOut`` (counterpart of ``torchmetrics_tpu/retrieval/fall_out.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalFallOut(RetrievalMetric):
    """Fall-out@k per query; a query with no *negative* target is the empty one.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalFallOut(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better: bool = False
    _empty_on_negatives: bool = True

    def __init__(
        self,
        empty_target_action: str = "pos",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.top_k = self._validate_top_k(top_k)

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        negative = (1 - target_mat) * valid
        retrieved_neg = (negative * self._in_topk(valid)).sum(dim=-1)
        n_neg = negative.sum(dim=-1)
        return torch.where(n_neg == 0, 0.0, retrieved_neg / torch.where(n_neg == 0, 1.0, n_neg))
