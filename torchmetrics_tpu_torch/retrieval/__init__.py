"""Retrieval metrics of the port (counterpart of ``torchmetrics_tpu/retrieval``)."""

from torchmetrics_tpu_torch.retrieval.average_precision import RetrievalMAP
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric
from torchmetrics_tpu_torch.retrieval.fall_out import RetrievalFallOut
from torchmetrics_tpu_torch.retrieval.hit_rate import RetrievalHitRate
from torchmetrics_tpu_torch.retrieval.ndcg import RetrievalNormalizedDCG
from torchmetrics_tpu_torch.retrieval.precision import RetrievalPrecision
from torchmetrics_tpu_torch.retrieval.precision_recall_curve import (
    RetrievalPrecisionRecallCurve,
    RetrievalRecallAtFixedPrecision,
)
from torchmetrics_tpu_torch.retrieval.r_precision import RetrievalRPrecision
from torchmetrics_tpu_torch.retrieval.recall import RetrievalRecall
from torchmetrics_tpu_torch.retrieval.reciprocal_rank import RetrievalMRR

__all__ = [
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMetric",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
]
