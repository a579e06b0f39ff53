"""distance_intersection_over_union (counterpart of ``torchmetrics_tpu/functional/detection/diou.py``)."""

from torchmetrics_tpu_torch.functional.detection._iou_variants import distance_intersection_over_union

__all__ = ["distance_intersection_over_union"]
