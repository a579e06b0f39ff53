"""Modular DistanceIntersectionOverUnion (counterpart of ``torchmetrics_tpu/detection/diou.py``)."""

from __future__ import annotations

from typing import Callable

from torchmetrics_tpu_torch.detection.iou import IntersectionOverUnion
from torchmetrics_tpu_torch.functional.detection.helpers import _box_diou


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """Mean DIoU over matched boxes; DIoU ranges in [-1, 1] so invalid pairs get -1.

    Example:
        >>> import torch
        >>> preds = [{'boxes': torch.tensor([[10.0, 10.0, 60.0, 60.0]]), 'scores': torch.tensor([0.9]), 'labels': torch.tensor([0])}]
        >>> target = [{'boxes': torch.tensor([[12.0, 10.0, 58.0, 62.0]]), 'labels': torch.tensor([0])}]
        >>> from torchmetrics_tpu_torch.detection.diou import DistanceIntersectionOverUnion
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print({k: round(float(v), 4) for k, v in sorted(metric.compute().items())})
        {'diou': 0.8872}
    """

    _iou_type: str = "diou"
    _invalid_val: float = -1.0
    _iou_kernel: Callable = staticmethod(_box_diou)
