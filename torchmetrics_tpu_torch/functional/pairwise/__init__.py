"""Pairwise functionals of the port (counterpart of ``torchmetrics_tpu/functional/pairwise``)."""

from torchmetrics_tpu_torch.functional.pairwise.cosine import pairwise_cosine_similarity
from torchmetrics_tpu_torch.functional.pairwise.euclidean import pairwise_euclidean_distance
from torchmetrics_tpu_torch.functional.pairwise.linear import pairwise_linear_similarity
from torchmetrics_tpu_torch.functional.pairwise.manhattan import pairwise_manhattan_distance
from torchmetrics_tpu_torch.functional.pairwise.minkowski import pairwise_minkowski_distance

__all__ = [
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_linear_similarity",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
]
