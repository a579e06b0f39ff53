"""generalized_intersection_over_union (counterpart of ``torchmetrics_tpu/functional/detection/giou.py``)."""

from torchmetrics_tpu_torch.functional.detection._iou_variants import generalized_intersection_over_union

__all__ = ["generalized_intersection_over_union"]
