"""Minkowski distance (counterpart of ``torchmetrics_tpu/functional/regression/minkowski.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


def _minkowski_p_validation(p: float) -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: torch.Tensor, targets: torch.Tensor, p: float) -> torch.Tensor:
    """Σ |error|^p."""
    _check_same_shape(preds, targets)
    _minkowski_p_validation(p)
    return torch.pow((preds - targets).abs(), p).sum()


def _minkowski_distance_compute(distance: torch.Tensor, p: float) -> torch.Tensor:
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds: torch.Tensor, targets: torch.Tensor, p: float) -> torch.Tensor:
    """Minkowski distance of order ``p``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import minkowski_distance
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(minkowski_distance(preds, target, p=3.0)), 4)
        1.0772
    """
    return _minkowski_distance_compute(_minkowski_distance_update(preds, targets, p), p)
