"""Modular PanopticQuality / ModifiedPanopticQuality (counterpart of
``torchmetrics_tpu/detection/panoptic_qualities.py``).

The per-category statistics are host numpy (``functional/detection/_panoptic_common.py``):
each update reads its two maps from the device in one copy and adds the batch's sums
into dense per-category sum states on the metric's device.
"""

from __future__ import annotations

from typing import Any, Collection, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.detection._panoptic_common import (
    _get_category_id_to_continuous_id,
    _get_void_color,
    _host_maps,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class PanopticQuality(Metric):
    """Panoptic Quality with per-category sum states.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2]]])
        >>> target = torch.tensor([[[0, 1], [0, 1], [6, 0], [7, 0], [1, 0]]])
        >>> from torchmetrics_tpu_torch.detection.panoptic_qualities import PanopticQuality
        >>> metric = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> metric.update(preds, target)
        >>> print(round(float(metric.compute()), 4))
        0.5
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    iou_sum: torch.Tensor
    true_positives: torch.Tensor
    false_positives: torch.Tensor
    false_negatives: torch.Tensor

    _modified_variant: bool = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things, stuffs = _parse_categories(things, stuffs)
        self.things = things
        self.stuffs = stuffs
        self.void_color = _get_void_color(things, stuffs)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
        self.allow_unknown_preds_category = allow_unknown_preds_category

        n_categories = len(things) + len(stuffs)
        self.add_state("iou_sum", default=torch.zeros(n_categories), dist_reduce_fx="sum")
        self.add_state("true_positives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", default=torch.zeros(n_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Fold one batch of (category, instance) maps into the category statistics."""
        _validate_inputs(preds, target)
        host_preds, host_target = _host_maps(preds, target)
        flatten_preds = _preprocess_inputs(
            self.things, self.stuffs, host_preds, self.void_color, self.allow_unknown_preds_category
        )
        flatten_target = _preprocess_inputs(self.things, self.stuffs, host_target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flatten_preds,
            flatten_target,
            self.cat_id_to_continuous_id,
            self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified_variant else None,
        )
        # one copy to the device: float64 holds the counts exactly
        stats = torch.from_numpy(np.stack([iou_sum, tp, fp, fn])).to(self.device)
        self.iou_sum = self.iou_sum + stats[0].to(self.iou_sum.dtype)
        self.true_positives = self.true_positives + stats[1].to(self.true_positives.dtype)
        self.false_positives = self.false_positives + stats[2].to(self.false_positives.dtype)
        self.false_negatives = self.false_negatives + stats[3].to(self.false_negatives.dtype)

    def compute(self) -> torch.Tensor:
        """Category-averaged PQ."""
        return _panoptic_quality_compute(self.iou_sum, self.true_positives, self.false_positives, self.false_negatives)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class ModifiedPanopticQuality(PanopticQuality):
    """PQ variant with per-segment stuff scoring."""

    _modified_variant: bool = True
