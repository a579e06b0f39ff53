"""Input validation helpers (counterpart of ``torchmetrics_tpu/utilities/checks.py``).

Metrics gate these behind ``validate_args``; a check that needs a value of the data
(``torch.unique``, ``torch.all``) waits for the device, so it is a host sync.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _check_same_shape(preds: torch.Tensor, target: torch.Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _is_floating(x: torch.Tensor) -> bool:
    return x.is_floating_point()


def _is_integral(x: torch.Tensor) -> bool:
    """Integer or boolean."""
    return not (x.is_floating_point() or x.is_complex())


def _check_retrieval_functional_inputs(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check and flatten the ``(preds, target)`` of one query."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if preds.numel() == 0:
        raise ValueError("`preds` and `target` must be non-empty")
    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")
    return _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)


def _check_retrieval_inputs(
    indexes: torch.Tensor,
    preds: torch.Tensor,
    target: torch.Tensor,
    allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the ``(indexes, preds, target)`` triple of a retrieval update and flatten it:
    int32 indexes, float32 scores, int32 relevance (float32 where graded relevance is
    allowed). Rows whose target is ``ignore_index`` are dropped, a boolean index that
    changes the shape, so a host sync, as in the JAX package."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
    if indexes.numel() == 0:
        raise ValueError("`indexes`, `preds` and `target` must be non-empty")
    if not _is_integral(indexes) or indexes.dtype == torch.bool:
        raise ValueError("`indexes` must be a tensor of long integers")
    if ignore_index is not None:
        valid = target != ignore_index
        indexes, preds, target = indexes[valid], preds[valid], target[valid]
    if not _is_floating(preds):
        raise ValueError("`preds` must be a tensor of floats")
    preds, target = _check_retrieval_target_and_prediction_types(preds, target, allow_non_binary_target)
    return indexes.reshape(-1).to(torch.int32), preds, target


def _check_retrieval_target_and_prediction_types(
    preds: torch.Tensor, target: torch.Tensor, allow_non_binary_target: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float32 scores and int32 (binary) or float32 (graded) relevance, flattened. The
    binary check reads the host on every call, as the JAX package's does."""
    if _is_floating(target):
        if not allow_non_binary_target:
            raise ValueError("`target` must be a tensor of booleans or integers")
    elif not _is_integral(target):
        raise ValueError("`target` must be a tensor of booleans, integers or floats")
    if not allow_non_binary_target and bool(((target > 1) | (target < 0)).any()):
        raise ValueError("`target` must contain `binary` values")
    t = target.to(torch.float32) if _is_floating(target) else target.to(torch.int32)
    return preds.reshape(-1).to(torch.float32), t.reshape(-1)
