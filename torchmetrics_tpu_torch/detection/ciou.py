"""Modular CompleteIntersectionOverUnion (counterpart of ``torchmetrics_tpu/detection/ciou.py``)."""

from __future__ import annotations

from typing import Callable

from torchmetrics_tpu_torch.detection.iou import IntersectionOverUnion
from torchmetrics_tpu_torch.functional.detection.helpers import _box_ciou


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """Mean CIoU over matched boxes; invalid pairs get the reference's -2 floor.

    Example:
        >>> import torch
        >>> preds = [{'boxes': torch.tensor([[10.0, 10.0, 60.0, 60.0]]), 'scores': torch.tensor([0.9]), 'labels': torch.tensor([0])}]
        >>> target = [{'boxes': torch.tensor([[12.0, 10.0, 58.0, 62.0]]), 'labels': torch.tensor([0])}]
        >>> from torchmetrics_tpu_torch.detection.ciou import CompleteIntersectionOverUnion
        >>> metric = CompleteIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print({k: round(float(v), 4) for k, v in sorted(metric.compute().items())})
        {'ciou': 0.8871}
    """

    _iou_type: str = "ciou"
    _invalid_val: float = -2.0
    _iou_kernel: Callable = staticmethod(_box_ciou)
