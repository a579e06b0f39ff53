"""intersection_over_union (counterpart of ``torchmetrics_tpu/functional/detection/iou.py``)."""

from torchmetrics_tpu_torch.functional.detection._iou_variants import intersection_over_union

__all__ = ["intersection_over_union"]
