"""Cosine similarity (counterpart of ``torchmetrics_tpu/functional/regression/cosine_similarity.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def _cosine_similarity_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the shapes and cast both sides to float32."""
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(
    preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum"
) -> torch.Tensor:
    """Row-wise cosine similarity under ``reduction``."""
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    reduction_mapping = {
        "sum": torch.sum,
        "mean": torch.mean,
        "none": lambda x: x,
        None: lambda x: x,
    }
    if reduction not in reduction_mapping:
        raise ValueError(f"Expected reduction to be one of {list(reduction_mapping)} but got {reduction}")
    return reduction_mapping[reduction](similarity)


def cosine_similarity(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Cosine similarity of the rows of ``preds`` and ``target``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        >>> target = torch.tensor([[1.0, 2.5], [2.5, 4.0], [5.5, 6.5]])
        >>> round(float(cosine_similarity(preds, target)), 4)
        2.9929
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
