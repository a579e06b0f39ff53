"""Input validation helpers (counterpart of ``torchmetrics_tpu/utilities/checks.py``).

Metrics gate these behind ``validate_args``; a check that needs a value of the data
(``torch.unique``, ``torch.all``) waits for the device, so it is a host sync.
"""

from __future__ import annotations

import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _is_floating(x: torch.Tensor) -> bool:
    return x.is_floating_point()
