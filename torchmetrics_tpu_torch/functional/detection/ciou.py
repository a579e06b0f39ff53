"""complete_intersection_over_union (counterpart of ``torchmetrics_tpu/functional/detection/ciou.py``)."""

from torchmetrics_tpu_torch.functional.detection._iou_variants import complete_intersection_over_union

__all__ = ["complete_intersection_over_union"]
