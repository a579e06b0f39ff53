"""Panoptic-quality machinery (counterpart of
``torchmetrics_tpu/functional/detection/_panoptic_common.py``).

The statistics are host numpy, as in the JAX package: every pixel's (category,
instance) color packs into one integer key, so segment areas and pairwise
intersections come out of one ``np.unique(..., return_counts=True)`` pass, and the
only loops run over unique intersection pairs. A batch's maps reach the host in one
copy (``_host_maps``); the per-category sums go back to the caller's device.
"""

from __future__ import annotations

from typing import Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate and dedupe the things/stuffs category sets."""
    things_parsed = set(things)
    if len(things_parsed) < len(things):
        rank_zero_warn("The provided `things` categories contained duplicates, which have been removed.", UserWarning)
    stuffs_parsed = set(stuffs)
    if len(stuffs_parsed) < len(stuffs):
        rank_zero_warn("The provided `stuffs` categories contained duplicates, which have been removed.", UserWarning)
    if not all(isinstance(val, (int, np.integer)) for val in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(val, (int, np.integer)) for val in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds, target) -> None:
    """Shape and type checks."""
    if not isinstance(preds, (torch.Tensor, np.ndarray)):
        raise TypeError(f"Expected argument `preds` to be an array, but got {type(preds)}")
    if not isinstance(target, (torch.Tensor, np.ndarray)):
        raise TypeError(f"Expected argument `target` to be an array, but got {type(target)}")
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same shape, but got {preds.shape} and {target.shape}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), "
            f"got {preds.shape}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {preds.shape} instead"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) color."""
    return 1 + max([0, *list(things), *list(stuffs)]), 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """Original category IDs -> dense [0, n) ids; things first."""
    mapping = {thing_id: idx for idx, thing_id in enumerate(things)}
    mapping.update({stuff_id: idx + len(things) for idx, stuff_id in enumerate(stuffs)})
    return mapping


def _host_maps(preds, target) -> Tuple[np.ndarray, np.ndarray]:
    """Both maps as int64 numpy arrays, read from the device in one copy."""
    if isinstance(preds, torch.Tensor) and isinstance(target, torch.Tensor) and preds.device == target.device:
        both = torch.stack([preds.to(torch.int64), target.to(torch.int64)]).cpu().numpy()
        return both[0], both[1]
    as_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)  # noqa: E731
    return as_np(preds).astype(np.int64), as_np(target).astype(np.int64)


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> np.ndarray:
    """Flatten spatial dims, zero stuff instance ids, map unknowns to void."""
    arr = np.asarray(inputs).astype(np.int64)
    arr = arr.reshape(arr.shape[0], -1, 2).copy()
    cats = arr[..., 0]
    mask_stuffs = np.isin(cats, list(stuffs))
    mask_things = np.isin(cats, list(things))
    arr[..., 1] = np.where(mask_stuffs, 0, arr[..., 1])
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not known.all():
        raise ValueError(f"Unknown categories found: {arr[~known]}")
    arr[~known] = np.asarray(void_color, dtype=np.int64)
    return arr


def _panoptic_stats_sample(
    pred_sample: np.ndarray,
    target_sample: np.ndarray,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (iou_sum, tp, fp, fn) dense per-category stats.

    For the modified variant, ``true_positives`` counts target segments for the selected
    stuff classes and ``iou_sum`` accumulates IoU at threshold 0 — identical compute
    formula downstream.
    """
    stuffs_modified_metric = stuffs_modified_metric or set()
    n_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(n_categories)
    true_positives = np.zeros(n_categories, dtype=np.int64)
    false_positives = np.zeros(n_categories, dtype=np.int64)
    false_negatives = np.zeros(n_categories, dtype=np.int64)

    # One vectorized pass. Category/instance ids can be arbitrarily large (COCO packs
    # RGB into instance ids, up to 2^24), so first densify both columns through
    # np.unique inverse codes — packed keys then stay far below int64 overflow.
    n_px = pred_sample.shape[0]
    both = np.concatenate([pred_sample, target_sample, np.asarray([void_color], dtype=np.int64)], axis=0)
    unique_cats, cat_codes = np.unique(both[:, 0], return_inverse=True)
    unique_insts, inst_codes = np.unique(both[:, 1], return_inverse=True)
    stride_inst = len(unique_insts)
    n_keys = len(unique_cats) * stride_inst
    keys = cat_codes * stride_inst + inst_codes

    pred_keys_px = keys[:n_px]
    target_keys_px = keys[n_px : 2 * n_px]
    void_key = int(keys[-1])

    def _key_category(key: int) -> int:
        return int(unique_cats[key // stride_inst])

    pred_colors, pred_counts = np.unique(pred_keys_px, return_counts=True)
    target_colors, target_counts = np.unique(target_keys_px, return_counts=True)
    pair_keys, pair_counts = np.unique(pred_keys_px * n_keys + target_keys_px, return_counts=True)
    pair_pred = pair_keys // n_keys
    pair_target = pair_keys % n_keys

    pred_area = dict(zip(pred_colors.tolist(), pred_counts.tolist()))
    target_area = dict(zip(target_colors.tolist(), target_counts.tolist()))
    inter_area = {
        (int(p), int(t)): int(c) for p, t, c in zip(pair_pred, pair_target, pair_counts)
    }

    pred_matched: Set[int] = set()
    target_matched: Set[int] = set()
    for (p_key, t_key), inter in inter_area.items():
        if t_key == void_key or p_key == void_key:
            continue
        p_cat, t_cat = _key_category(p_key), _key_category(t_key)
        if p_cat != t_cat:
            continue
        pred_void = inter_area.get((p_key, void_key), 0)
        void_target = inter_area.get((void_key, t_key), 0)
        union = pred_area[p_key] - pred_void + target_area[t_key] - void_target - inter
        iou = inter / union if union > 0 else 0.0
        continuous_id = cat_id_to_continuous_id[int(t_cat)]
        if t_cat not in stuffs_modified_metric and iou > 0.5:
            pred_matched.add(p_key)
            target_matched.add(t_key)
            iou_sum[continuous_id] += iou
            true_positives[continuous_id] += 1
        elif t_cat in stuffs_modified_metric and iou > 0:
            iou_sum[continuous_id] += iou

    # FN: unmatched target segments not mostly covered by void in the prediction.
    for t_key, area in target_area.items():
        if t_key == void_key or t_key in target_matched:
            continue
        cat = _key_category(t_key)
        if cat in stuffs_modified_metric:
            continue
        if inter_area.get((void_key, t_key), 0) / area <= 0.5:
            false_negatives[cat_id_to_continuous_id[cat]] += 1

    # FP: unmatched predicted segments not mostly void in the target.
    for p_key, area in pred_area.items():
        if p_key == void_key or p_key in pred_matched:
            continue
        cat = _key_category(p_key)
        if cat in stuffs_modified_metric:
            continue
        if inter_area.get((p_key, void_key), 0) / area <= 0.5:
            false_positives[cat_id_to_continuous_id[cat]] += 1

    # Modified variant: each target segment of a selected stuff class counts once.
    for t_key in target_area:
        if t_key == void_key:
            continue
        cat = _key_category(t_key)
        if cat in stuffs_modified_metric:
            true_positives[cat_id_to_continuous_id[cat]] += 1

    return iou_sum, true_positives, false_positives, false_negatives


def _panoptic_quality_update(
    flatten_preds: np.ndarray,
    flatten_target: np.ndarray,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batch stats: per-sample matching folded into dense category arrays (float64 IoU
    sums, int64 counts, on the host)."""
    n_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(n_categories)
    true_positives = np.zeros(n_categories, dtype=np.int64)
    false_positives = np.zeros(n_categories, dtype=np.int64)
    false_negatives = np.zeros(n_categories, dtype=np.int64)
    for pred_sample, target_sample in zip(flatten_preds, flatten_target):
        result = _panoptic_stats_sample(
            pred_sample, target_sample, cat_id_to_continuous_id, void_color, modified_metric_stuffs
        )
        iou_sum += result[0]
        true_positives += result[1]
        false_positives += result[2]
        false_negatives += result[3]
    return iou_sum, true_positives, false_positives, false_negatives


def _panoptic_quality_compute(
    iou_sum: torch.Tensor,
    true_positives: torch.Tensor,
    false_positives: torch.Tensor,
    false_negatives: torch.Tensor,
) -> torch.Tensor:
    """``mean_cat( IoU_sum / (TP + FP/2 + FN/2) )`` over the seen categories, in float64
    (so the card and the CPU, which sum in other orders, round to the same float32)."""
    iou_sum, true_positives, false_positives, false_negatives = (
        x.to(torch.float64) for x in (iou_sum, true_positives, false_positives, false_negatives)
    )
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    seen = denominator > 0
    per_category = torch.where(seen, iou_sum / torch.where(seen, denominator, torch.ones_like(denominator)), 0.0)
    n_seen = seen.sum()
    return (per_category.sum() / torch.where(n_seen > 0, n_seen, 1)).to(torch.float32)
