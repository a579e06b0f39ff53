"""Retrieval R-precision (counterpart of ``torchmetrics_tpu/functional/retrieval/r_precision.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_functional_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending


def retrieval_r_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Precision at rank R, R the number of relevant documents, as a mask over the
    ranks (no slice by a value on the device).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.retrieval import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.7])
        >>> target = torch.tensor([False, True, False, True])
        >>> round(float(retrieval_r_precision(preds, target)), 4)
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)

    rel = target[_argsort_descending(preds)].to(torch.float32)
    n_rel = rel.sum()
    ranks = torch.arange(1, rel.shape[-1] + 1, device=rel.device)
    hit = torch.sum(rel * (ranks <= n_rel).to(torch.float32))
    return torch.where(n_rel == 0, 0.0, hit / torch.where(n_rel == 0, 1.0, n_rel))
