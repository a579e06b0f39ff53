"""Panoptic quality functionals (counterpart of
``torchmetrics_tpu/functional/detection/panoptic_qualities.py``)."""

from __future__ import annotations

from typing import Collection

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


def _quality(preds, target, things, stuffs, allow_unknown_preds_category: bool, modified: bool) -> torch.Tensor:
    things, stuffs = _parse_categories(things, stuffs)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things, stuffs)
    cat_id_to_continuous_id = _get_category_id_to_continuous_id(things, stuffs)
    host_preds, host_target = _host_maps(preds, target)
    flatten_preds = _preprocess_inputs(things, stuffs, host_preds, void_color, allow_unknown_preds_category)
    flatten_target = _preprocess_inputs(things, stuffs, host_target, void_color, True)
    stats = _panoptic_quality_update(
        flatten_preds, flatten_target, cat_id_to_continuous_id, void_color,
        modified_metric_stuffs=stuffs if modified else None,
    )
    device = preds.device if isinstance(preds, torch.Tensor) else torch.device("cpu")
    # the float64 host sums, as they were taken; the value is float32
    return _panoptic_quality_compute(*(torch.from_numpy(s) for s in stats)).to(device)


def panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> torch.Tensor:
    r"""Compute Panoptic Quality for panoptic segmentations.

    ``PQ = IoU_sum / (TP + 0.5 FP + 0.5 FN)`` per category, averaged over seen categories.

    Args:
        preds: ``(B, *spatial, 2)`` array of ``(category_id, instance_id)`` pairs per pixel.
        target: ground truth of the same shape.
        things: category ids of countable things (instances distinguished).
        stuffs: category ids of uncountable stuffs (instance id ignored).
        allow_unknown_preds_category: map unknown predicted categories to void instead of raising.
    """
    return _quality(preds, target, things, stuffs, allow_unknown_preds_category, modified=False)


def modified_panoptic_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> torch.Tensor:
    r"""Modified Panoptic Quality: stuff classes scored per-segment at IoU > 0.

    Adaptation from the Seamless Scene Segmentation paper where each stuff class
    contributes its summed IoU over target segments rather than 0.5-thresholded matches.
    """
    return _quality(preds, target, things, stuffs, allow_unknown_preds_category, modified=True)
