"""Root aliases of the retrieval metrics, which warn at construction (counterpart of
``torchmetrics_tpu/retrieval/_deprecated.py``)."""

from torchmetrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRPrecision,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
)
from torchmetrics_tpu_torch.utilities.deprecation import root_alias

_RetrievalFallOut = root_alias(RetrievalFallOut, "retrieval")
_RetrievalHitRate = root_alias(RetrievalHitRate, "retrieval")
_RetrievalMAP = root_alias(RetrievalMAP, "retrieval")
_RetrievalMRR = root_alias(RetrievalMRR, "retrieval")
_RetrievalNormalizedDCG = root_alias(RetrievalNormalizedDCG, "retrieval")
_RetrievalPrecision = root_alias(RetrievalPrecision, "retrieval")
_RetrievalPrecisionRecallCurve = root_alias(RetrievalPrecisionRecallCurve, "retrieval")
_RetrievalRPrecision = root_alias(RetrievalRPrecision, "retrieval")
_RetrievalRecall = root_alias(RetrievalRecall, "retrieval")
_RetrievalRecallAtFixedPrecision = root_alias(RetrievalRecallAtFixedPrecision, "retrieval")
