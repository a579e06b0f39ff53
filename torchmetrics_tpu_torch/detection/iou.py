"""Modular IntersectionOverUnion (counterpart of ``torchmetrics_tpu/detection/iou.py``).

The GIoU / DIoU / CIoU modular metrics subclass this one, swapping the pairwise kernel.
``update`` scores each image on the metric's device and reads nothing back; ``compute``
reads each list state with one copy (``helpers._bulk_to_host``) and averages on the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from torchmetrics_tpu_torch.detection.helpers import _bulk_to_host, _fix_empty_tensors, _input_validator
from torchmetrics_tpu_torch.functional.detection._iou_variants import _variant_compute, _variant_update
from torchmetrics_tpu_torch.functional.detection.helpers import _box_convert, _box_iou
from torchmetrics_tpu_torch.metric import Metric


class IntersectionOverUnion(Metric):
    """Mean IoU over matched detection / ground-truth boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
        >>> preds = [{'boxes': torch.tensor([[296.55, 93.96, 314.97, 152.79]]), 'scores': torch.tensor([0.236]), 'labels': torch.tensor([4])}]
        >>> target = [{'boxes': torch.tensor([[300.00, 100.00, 315.00, 150.00]]), 'labels': torch.tensor([4])}]
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> print({k: round(float(v), 4) for k, v in metric(preds, target).items()})
        {'iou': 0.6898}
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True

    detection_labels: List[torch.Tensor]
    groundtruth_labels: List[torch.Tensor]
    results: List[torch.Tensor]

    _iou_type: str = "iou"
    _invalid_val: float = 0.0
    _iou_kernel: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = staticmethod(_box_iou)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        self.add_state("results", default=[], dist_reduce_fx=None)

    def update(self, preds: Sequence[Dict[str, Any]], target: Sequence[Dict[str, Any]]) -> None:
        """Score one batch of per-image box dicts."""
        _input_validator(preds, target)

        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            p_labels = torch.as_tensor(p["labels"], device=self.device)
            t_labels = torch.as_tensor(t["labels"], device=self.device)
            self.detection_labels.append(p_labels)
            self.groundtruth_labels.append(t_labels)

            ious = _variant_update(type(self)._iou_kernel, det_boxes, gt_boxes, self.iou_threshold, self._invalid_val)
            if self.respect_labels and ious.numel() > 0:
                # on the device whatever the labels: when they agree the mask is all
                # False and this is the identity, with no host read
                labels_not_eq = p_labels[:, None] != t_labels[None, :]
                ious = torch.where(labels_not_eq, torch.full_like(ious, self._invalid_val), ious)
            self.results.append(ious.to(torch.float32))

    def _get_safe_item_values(self, boxes: Any) -> torch.Tensor:
        boxes = _fix_empty_tensors(torch.as_tensor(boxes, dtype=torch.float32, device=self.device))
        if boxes.numel() > 0:
            boxes = _box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def compute(self) -> Dict[str, torch.Tensor]:
        """Mean of each image's matched-pair scores, and per ground-truth class if asked."""
        results = _bulk_to_host(self.results)
        d_labels = [x.reshape(-1) for x in _bulk_to_host(self.detection_labels)]
        g_labels = [x.reshape(-1) for x in _bulk_to_host(self.groundtruth_labels)]
        per_image = []
        for iou_mat, d_np, g_np in zip(results, d_labels, g_labels):
            if iou_mat.size == 0:
                continue  # an image without objects: nothing to average
            labels_eq = d_np.shape == g_np.shape and bool((d_np == g_np).all())
            per_image.append(_variant_compute(torch.from_numpy(iou_mat), labels_eq).reshape(1))
        aggregated = torch.cat(per_image) if per_image else torch.zeros(0)
        out: Dict[str, torch.Tensor] = {
            self._iou_type: aggregated.mean() if aggregated.numel() else torch.tensor(0.0)
        }

        if self.class_metrics:
            gt_classes = np.unique(np.concatenate(g_labels)).astype(int).tolist() if g_labels else []
            for cl in gt_classes:
                masked_scores = [
                    iou_mat[(d_np.reshape(-1, 1) == cl) & (g_np.reshape(1, -1) == cl)]
                    for iou_mat, d_np, g_np in zip(results, d_labels, g_labels)
                    if iou_mat.size
                ]
                masked_scores = [s for s in masked_scores if s.size]
                if masked_scores:
                    out[f"{self._iou_type}/cl_{cl}"] = torch.from_numpy(np.concatenate(masked_scores)).mean()
        return {k: v.to(self.device) for k, v in out.items()}

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
