"""``RetrievalPrecisionRecallCurve`` and ``RetrievalRecallAtFixedPrecision`` (counterpart
of ``torchmetrics_tpu/retrieval/precision_recall_curve.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric
from torchmetrics_tpu_torch.utilities.plot import plot_curve


def _retrieval_recall_at_fixed_precision(
    precision: torch.Tensor, recall: torch.Tensor, top_k: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The highest recall among the points whose precision is at least
    ``min_precision``, and its k (the largest k on a tie of recalls; ``len(top_k)`` when
    the recall is 0). Picked on the host, as the JAX package picks it, from one read of
    the three curves (the ks are small integers, exact in float32); the answer is then
    taken from the curves on their device, so no value is copied back to it."""
    curves = torch.stack([precision, recall, top_k.to(precision.dtype)]).tolist()
    best = max(((r, k, i) for i, (p, r, k) in enumerate(zip(*curves)) if p >= min_precision), default=None)
    if best is None or best[0] == 0.0:
        return (
            torch.zeros((), dtype=torch.float32, device=recall.device),
            torch.full((), len(top_k), dtype=torch.int32, device=recall.device),
        )
    return recall[best[2]].to(torch.float32), top_k[best[2]].to(torch.int32)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Precision@k and recall@k averaged over queries, for k in [1, max_k].

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalPrecisionRecallCurve(max_k=2, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> precision, recall, top_k = metric.compute()
        >>> precision.tolist(), recall.tolist(), top_k.tolist()
        ([1.0, 0.5], [0.75, 0.75], [1, 2])
    """

    def __init__(
        self,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        self.max_k = self._validate_top_k(max_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:  # type: ignore[override]
        """The averaged curves over the dense rank matrix."""
        preds_mat, target_mat, valid = self._packed()
        max_len = target_mat.shape[-1]
        max_k = self.max_k if self.max_k is not None else max_len
        ks = torch.arange(1, max_k + 1, device=target_mat.device)

        # relevant documents in the first k ranks, each row cut to its own documents
        padded_t = torch.nn.functional.pad(target_mat * valid, (0, max(0, max_k - max_len)))[:, :max_k]
        relevant = torch.cumsum(padded_t, dim=-1)

        if self.adaptive_k:
            topk = torch.minimum(ks, valid.sum(dim=-1, keepdim=True)).to(torch.float32)
        else:
            topk = ks.to(torch.float32).expand(relevant.shape)

        n_pos = (target_mat * valid).sum(dim=-1, keepdim=True)
        recalls = torch.where(n_pos == 0, 0.0, relevant / torch.where(n_pos == 0, 1.0, n_pos))
        precisions = torch.where(n_pos == 0, 0.0, relevant / topk)

        empty = n_pos.squeeze(-1) == 0
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action == "skip":
            keep = ~empty
            n_kept = int(keep.sum())
            if n_kept == 0:
                zero = torch.zeros(max_k, device=target_mat.device)
                return zero, zero, ks
            precision = (precisions * keep[:, None]).sum(dim=0) / n_kept
            recall = (recalls * keep[:, None]).sum(dim=0) / n_kept
        else:
            fill = 1.0 if self.empty_target_action == "pos" else 0.0
            precision = torch.where(empty[:, None], fill, precisions).mean(dim=0)
            recall = torch.where(empty[:, None], fill, recalls).mean(dim=0)
        return precision, recall, ks

    def plot(self, curve: Optional[Tuple[torch.Tensor, ...]] = None, ax: Optional[Any] = None) -> Any:
        curve = curve or self.compute()
        return plot_curve(curve, ax=ax, label_names=("Recall", "Precision"), name=type(self).__name__)


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The highest recall@k whose precision@k is at least ``min_precision``, and its k.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> tuple(round(float(v), 4) for v in metric.compute())
        (1.0, 3.0)
    """

    def __init__(
        self,
        min_precision: float = 0.0,
        max_k: Optional[int] = None,
        adaptive_k: bool = False,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            max_k=max_k, adaptive_k=adaptive_k, empty_target_action=empty_target_action,
            ignore_index=ignore_index, **kwargs,
        )
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a float between 0 and 1")
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        precision, recall, top_k = super().compute()
        return _retrieval_recall_at_fixed_precision(precision, recall, top_k, self.min_precision)
