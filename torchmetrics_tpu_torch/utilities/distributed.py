"""Generic reductions and the gather (counterpart of ``torchmetrics_tpu/utilities/distributed.py``).

The gather lives in ``parallel/sync.py`` (``torch.distributed``) and is re-exported here
so the upstream import paths keep working.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.parallel.sync import (  # noqa: F401  (re-export)
    _simple_gather_all_tensors,
    distributed_available,
    gather_all_tensors,
)


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """Reduce a tensor by ``"elementwise_mean"``, ``"sum"`` or ``"none"``."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "none" or reduction is None:
        return x
    if reduction == "sum":
        return torch.sum(x)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: str = "none"
) -> torch.Tensor:
    """Per-class fractions reduced by ``"micro"``, ``"macro"``, ``"weighted"`` or
    ``"none"``; a class whose denominator is 0 counts as 0."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), 0.0, fraction)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
