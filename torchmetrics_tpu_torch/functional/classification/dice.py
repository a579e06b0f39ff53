"""Dice score with the legacy input auto-format (counterpart of
``torchmetrics_tpu/functional/classification/dice.py``).

Dice = 2·tp / (2·tp + fp + fn). Labels, probabilities with a threshold and
``(N, C, ...)`` scores are turned into one-hot ``(N, C, ...)`` int32 masks, then
counted per class (or per sample and class). The one-hots are comparisons with the
class indices (``_one_hot``) and the argmax follows K1's rule (the first index wins a
tie, NaN is maximal), so an update on ``(N, C)`` scores reads nothing back to the host.
Integer labels of the same shape with ``num_classes`` given read the labels' ``max()``
on the host, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits
from torchmetrics_tpu_torch.ops.stat_counts import _argmax_nan_first
from torchmetrics_tpu_torch.utilities.checks import _is_floating
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _one_hot, select_topk

_ALLOWED_AVERAGE = ("micro", "macro", "weighted", "samples", "none", None)


def _one_hot_classes_first(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``(N, ...)`` labels to an int32 ``(N, C, ...)`` one-hot."""
    return torch.movedim(_one_hot(labels, num_classes), -1, 1)


def _dice_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Legacy auto-format to one-hot ``(N, C, ...)`` int32 masks."""
    if preds.ndim == target.ndim + 1:
        # (N, C, ...) scores against (N, ...) labels
        num_classes = preds.shape[1]
        if top_k is not None and top_k > 1:
            preds_oh = select_topk(preds, topk=top_k, dim=1)
        else:
            preds_oh = _one_hot_classes_first(_argmax_nan_first(preds), num_classes)
        return preds_oh, _one_hot_classes_first(target, num_classes)
    if _is_floating(preds):
        # same-shape probabilities or logits -> binary masks
        preds = (_sigmoid_if_logits(preds) > threshold).to(torch.int32)
    if num_classes is not None and num_classes > 1 and preds.ndim == target.ndim and not _is_floating(preds):
        mx = max(int(preds.max()) if preds.numel() else 0, int(target.max()) if target.numel() else 0)
        if mx > 1 or num_classes > 2:
            return _one_hot_classes_first(preds, num_classes), _one_hot_classes_first(target, num_classes)
    # binary labels: a two-class one-hot over {0, 1}, stacked as [1 - x, x]
    preds_2 = torch.stack([1 - preds, preds], dim=1)
    target_2 = torch.stack([1 - target, target], dim=1)
    return preds_2.to(torch.int32), target_2.to(torch.int32)


def _dice_update(
    preds_oh: torch.Tensor,
    target_oh: torch.Tensor,
    ignore_index: Optional[int] = None,
    mdmc_average: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (or per-sample and class) int32 tp / fp / fn counts."""
    if ignore_index is not None and 0 <= ignore_index < target_oh.shape[1]:
        mask = torch.ones(target_oh.shape[1], dtype=torch.int32, device=target_oh.device)
        mask[ignore_index] = 0
        shape = [1, -1] + [1] * (target_oh.ndim - 2)
        preds_oh = preds_oh * mask.reshape(shape)
        target_oh = target_oh * mask.reshape(shape)
    if mdmc_average == "samplewise" and preds_oh.ndim > 2:
        dims = tuple(range(2, preds_oh.ndim))  # keep (N, C)
    else:
        preds_oh = preds_oh.reshape(preds_oh.shape[0], preds_oh.shape[1], -1)
        target_oh = target_oh.reshape(target_oh.shape[0], target_oh.shape[1], -1)
        dims = (0, 2)
    tp = ((preds_oh == 1) & (target_oh == 1)).sum(dim=dims, dtype=torch.int32)
    fp = ((preds_oh == 1) & (target_oh == 0)).sum(dim=dims, dtype=torch.int32)
    fn = ((preds_oh == 0) & (target_oh == 1)).sum(dim=dims, dtype=torch.int32)
    return tp, fp, fn


def _samplewise_dice(tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, zero_division: float) -> torch.Tensor:
    """Each sample's micro dice over its classes, averaged over the samples."""
    tp, fp, fn = tp.sum(-1), fp.sum(-1), fn.sum(-1)
    return _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division).mean()


def _dice_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str] = "micro",
    zero_division: float = 0.0,
) -> torch.Tensor:
    """Reduce tp / fp / fn into a dice score."""
    if average == "micro":
        tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
        return _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
    score = _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
    if average in (None, "none"):
        return score
    if average == "samples":
        return _samplewise_dice(tp, fp, fn, zero_division)
    if average == "weighted":
        weights = (tp + fn).to(torch.float32)
        return (score * _safe_divide(weights, weights.sum())).sum()
    if average == "macro":
        present = (tp + fp + fn) > 0
        return torch.where(present, score, 0.0).sum() / torch.clamp(present.sum(), min=1)
    raise ValueError(f"Unsupported average: {average}")


def dice(
    preds: torch.Tensor,
    target: torch.Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Dice score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import dice
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> float(dice(preds, target, average="micro", num_classes=3))
        0.25
    """
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
    preds_oh, target_oh = _dice_format(preds, target, threshold, top_k, num_classes)
    samplewise = mdmc_average == "samplewise" or average == "samples"
    tp, fp, fn = _dice_update(preds_oh, target_oh, ignore_index, "samplewise" if samplewise else None)
    if mdmc_average == "samplewise" and average != "samples":
        return _samplewise_dice(tp, fp, fn, zero_division)
    return _dice_compute(tp, fp, fn, average=average, zero_division=zero_division)
