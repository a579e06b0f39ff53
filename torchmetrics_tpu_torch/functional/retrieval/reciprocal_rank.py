"""Retrieval reciprocal rank (counterpart of ``torchmetrics_tpu/functional/retrieval/reciprocal_rank.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_reciprocal_rank(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 / the rank of the first relevant document, 0 when none is relevant.
    ``argmax`` over the ranked int32 relevance finds the first hit with no host read.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_reciprocal_rank(preds, target)), 4)
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    rel = target[_argsort_descending(preds)]
    first = torch.argmax(rel)
    return torch.where(rel.sum() == 0, 0.0, 1.0 / (first + 1.0))
