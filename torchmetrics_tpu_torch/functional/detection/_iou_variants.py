"""Shared machinery of the four box-overlap functionals (counterpart of
``torchmetrics_tpu/functional/detection/_iou_variants.py``).

One factory builds all four from the pairwise kernels in ``helpers.py``; the threshold
is a ``torch.where``, so nothing is read back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from torchmetrics_tpu_torch.functional.detection.helpers import _box_ciou, _box_diou, _box_giou, _box_iou


def _variant_update(
    kernel: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    preds: torch.Tensor,
    target: torch.Tensor,
    iou_threshold: Optional[float],
    replacement_val: float = 0,
) -> torch.Tensor:
    """Pairwise score matrix with the entries below the threshold replaced."""
    scores = kernel(torch.as_tensor(preds, dtype=torch.float32), torch.as_tensor(target, dtype=torch.float32))
    if iou_threshold is not None:
        scores = torch.where(scores < iou_threshold, torch.full_like(scores, replacement_val), scores)
    return scores


def _variant_compute(scores: torch.Tensor, labels_eq: bool = True) -> torch.Tensor:
    """Mean of the matched diagonal, or of all pairs when the labels differ."""
    if labels_eq:
        return torch.diagonal(scores).mean()
    return scores.mean()


def _make_variant(kernel: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], public_name: str) -> Callable:
    def fn(
        preds: torch.Tensor,
        target: torch.Tensor,
        iou_threshold: Optional[float] = None,
        replacement_val: float = 0,
        aggregate: bool = True,
    ) -> torch.Tensor:
        scores = _variant_update(kernel, preds, target, iou_threshold, replacement_val)
        return _variant_compute(scores) if aggregate else scores

    fn.__name__ = public_name
    fn.__qualname__ = public_name
    fn.__doc__ = (
        f"Compute ``{public_name}`` between two sets of xyxy boxes.\n\n"
        "Args:\n"
        "    preds: ``(N, 4)`` predicted boxes, ``(x1, y1, x2, y2)`` with ``x1 < x2``, ``y1 < y2``.\n"
        "    target: ``(M, 4)`` ground-truth boxes in the same layout.\n"
        "    iou_threshold: optional floor; entries below it become ``replacement_val``.\n"
        "    replacement_val: value written for the pairs below the threshold.\n"
        "    aggregate: return the matched-pair mean instead of the full ``(N, M)`` matrix.\n\n"
        "Runs on the inputs' device; float32 whatever the inputs' dtype."
    )
    return fn


intersection_over_union = _make_variant(_box_iou, "intersection_over_union")
generalized_intersection_over_union = _make_variant(_box_giou, "generalized_intersection_over_union")
distance_intersection_over_union = _make_variant(_box_diou, "distance_intersection_over_union")
complete_intersection_over_union = _make_variant(_box_ciou, "complete_intersection_over_union")
