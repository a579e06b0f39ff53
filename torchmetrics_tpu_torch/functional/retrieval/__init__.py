"""Functional retrieval metrics of the port (counterpart of ``torchmetrics_tpu/functional/retrieval``).

Each takes the scores and relevance of one query. Documents are ranked by a stable
descending sort with NaN last (``utilities/data._argsort_descending``), the order of the
JAX package's ``jnp.argsort(-preds)``: tied scores keep their input order.
"""

from torchmetrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision
from torchmetrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out
from torchmetrics_tpu_torch.functional.retrieval.hit_rate import retrieval_hit_rate
from torchmetrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg
from torchmetrics_tpu_torch.functional.retrieval.precision import retrieval_precision
from torchmetrics_tpu_torch.functional.retrieval.precision_recall_curve import retrieval_precision_recall_curve
from torchmetrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision
from torchmetrics_tpu_torch.functional.retrieval.recall import retrieval_recall
from torchmetrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank

__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
