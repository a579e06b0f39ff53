"""Modular GeneralizedIntersectionOverUnion (counterpart of ``torchmetrics_tpu/detection/giou.py``)."""

from __future__ import annotations

from typing import Callable

from torchmetrics_tpu_torch.detection.iou import IntersectionOverUnion
from torchmetrics_tpu_torch.functional.detection.helpers import _box_giou


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """Mean GIoU over matched boxes; GIoU ranges in [-1, 1] so invalid pairs get -1.

    Example:
        >>> import torch
        >>> preds = [{'boxes': torch.tensor([[10.0, 10.0, 60.0, 60.0]]), 'scores': torch.tensor([0.9]), 'labels': torch.tensor([0])}]
        >>> target = [{'boxes': torch.tensor([[12.0, 10.0, 58.0, 62.0]]), 'labels': torch.tensor([0])}]
        >>> from torchmetrics_tpu_torch.detection.giou import GeneralizedIntersectionOverUnion
        >>> metric = GeneralizedIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print({k: round(float(v), 4) for k, v in sorted(metric.compute().items())})
        {'giou': 0.8843}
    """

    _iou_type: str = "giou"
    _invalid_val: float = -1.0
    _iou_kernel: Callable = staticmethod(_box_giou)
