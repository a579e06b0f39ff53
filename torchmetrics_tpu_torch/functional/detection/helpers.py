"""Box kernels for the detection domain (counterpart of
``torchmetrics_tpu/functional/detection/helpers.py``).

Plain PyTorch broadcasting over an ``(N, 4) x (M, 4) -> (N, M)`` grid, with no
data-dependent control flow and no host read: the torchvision ops the reference leans
on (``box_iou``, ``box_convert``, ``generalized_box_iou``, ``distance_box_iou``,
``complete_box_iou``), written out so the port needs no torchvision.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-7  # torchvision's eps in the distance / complete IoU denominators

_ALLOWED_BOX_FORMATS = ("xyxy", "xywh", "cxcywh")


def _box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str) -> torch.Tensor:
    """Convert ``(..., 4)`` boxes between the xyxy / xywh / cxcywh layouts."""
    if in_fmt not in _ALLOWED_BOX_FORMATS or out_fmt not in _ALLOWED_BOX_FORMATS:
        raise ValueError(f"Box formats must be one of {_ALLOWED_BOX_FORMATS}, got {in_fmt} -> {out_fmt}")
    if in_fmt == out_fmt:
        return boxes
    a, b, c, d = boxes.unbind(-1)
    if in_fmt == "xywh":
        x1, y1, x2, y2 = a, b, a + c, b + d
    elif in_fmt == "cxcywh":
        x1, y1, x2, y2 = a - c / 2, b - d / 2, a + c / 2, b + d / 2
    else:
        x1, y1, x2, y2 = a, b, c, d
    if out_fmt == "xyxy":
        out = (x1, y1, x2, y2)
    elif out_fmt == "xywh":
        out = (x1, y1, x2 - x1, y2 - y1)
    else:
        out = ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
    return torch.stack(out, dim=-1)


def _box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of ``(..., 4)`` xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _box_inter_union(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise intersection and union matrices of xyxy boxes."""
    area1 = _box_area(preds)
    area2 = _box_area(target)
    lt = torch.maximum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.minimum(preds[..., :, None, 2:], target[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with a zero denominator read as 1 (IoU 0 for empty unions)."""
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _box_iou(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU matrix ``(..., N, M)`` of xyxy boxes (leading batch dims broadcast)."""
    inter, union = _box_inter_union(preds, target)
    return _safe_div(inter, union)


def _enclosing_box(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Width and height of the smallest box enclosing each pred / target pair."""
    lt = torch.minimum(preds[:, None, :2], target[None, :, :2])
    rb = torch.maximum(preds[:, None, 2:], target[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    return wh[..., 0], wh[..., 1]


def _box_giou(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise generalized IoU: ``iou - (enclose - union) / enclose``."""
    inter, union = _box_inter_union(preds, target)
    iou = _safe_div(inter, union)
    ew, eh = _enclosing_box(preds, target)
    enclose = ew * eh
    return iou - _safe_div(enclose - union, enclose)


def _center_distance_sq(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared distance between box centers, pairwise."""
    cp = (preds[:, None, :2] + preds[:, None, 2:]) / 2
    ct = (target[None, :, :2] + target[None, :, 2:]) / 2
    diff = cp - ct
    return diff[..., 0] ** 2 + diff[..., 1] ** 2


def _box_diou(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise distance IoU: ``iou - d^2 / c^2`` (c the enclosing box's diagonal)."""
    iou = _box_iou(preds, target)
    ew, eh = _enclosing_box(preds, target)
    diag_sq = ew**2 + eh**2 + _EPS
    return iou - _center_distance_sq(preds, target) / diag_sq


def _box_ciou(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pairwise complete IoU: the distance IoU minus the aspect-ratio consistency term."""
    iou = _box_iou(preds, target)
    ew, eh = _enclosing_box(preds, target)
    diag_sq = ew**2 + eh**2 + _EPS
    dist_term = _center_distance_sq(preds, target) / diag_sq
    wp = preds[:, 2] - preds[:, 0]
    hp = preds[:, 3] - preds[:, 1]
    wt = target[:, 2] - target[:, 0]
    ht = target[:, 3] - target[:, 1]
    v = (4 / math.pi**2) * (torch.atan(wt / (ht + _EPS))[None, :] - torch.atan(wp / (hp + _EPS))[:, None]) ** 2
    alpha = v / (1 - iou + v + _EPS)
    return iou - dist_term - alpha * v
