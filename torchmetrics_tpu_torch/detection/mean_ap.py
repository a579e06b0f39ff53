"""MeanAveragePrecision (counterpart of ``torchmetrics_tpu/detection/mean_ap.py``).

The metric streams raw per-image tensors into ``dist_reduce_fx=None`` list states on its
device. ``compute`` is an epoch-end evaluation with COCOeval semantics on the host:

- each list state comes to the host with one device read (``helpers._bulk_to_host``:
  a ``torch.cat`` on the device, one copy, a split by the shapes the host knows), so a
  5000-image epoch reads the device at most 9 times, not once per image;
- ``bbox`` with ascending recall thresholds calls the C++ epoch evaluator
  (``native/match.cpp:coco_eval_bbox``) once;
- everything else (``segm``, non-ascending recall thresholds) runs ``_calculate``:
  float64 numpy IoU (dense masks as one flattened product, RLE dicts through
  ``native/rle.cpp``) and the greedy matcher ``native/match.cpp:coco_match`` per
  (image, class) pair.

Every compute is an epoch-end readback sanctioned as ``transfer_allowed("map-host-matcher")``,
so a strict transfer guard around an eval loop stays clean, and is counted as a
heavy-workload host fallback (``map_host_evals`` and a ``heavy.fallback`` event).

The packed-dict route (``update`` with dicts of padded ``(B, M, ...)`` tensors) keeps
one buffer per update. Its in-graph sibling, which evaluates on the card, is
:class:`~torchmetrics_tpu_torch.detection.ingraph.PackedMeanAveragePrecision`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.detection.helpers import _bulk_to_host, _fix_empty_tensors, _input_validator
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.functional.detection.helpers import _box_convert
from torchmetrics_tpu_torch.metric import Metric

# one EngineStats for the module: every compute runs the host evaluator, counted as
# ``map_host_evals`` so ``engine_report()`` shows which eval loops still match on the host
_STATS = EngineStats("mean_ap")

_LABEL_F32_BOUND_MSG = (
    "Packed `{}` labels reach |{}| >= 2**24: class ids of that magnitude are not"
    " exactly representable in the f32 packed channel and would be silently rounded"
    " to a wrong class. Use the per-image list update path for such ids."
)


def _check_packed_label_bound(name: str, labels_2d: np.ndarray, counts: np.ndarray) -> None:
    """Raise when any VALID-row label magnitude breaks f32 exactness (|v| >= 2**24).

    Rows past each image's count are padding and may hold sentinels; they are
    never read back, so they are exempt.
    """
    valid = np.arange(labels_2d.shape[-1]) < np.asarray(counts).reshape(-1, 1)
    masked = np.abs(np.where(valid, labels_2d, 0))
    if masked.size and float(masked.max()) >= 2**24:
        raise ValueError(_LABEL_F32_BOUND_MSG.format(name, int(masked.max())))


def _validate_packed_batch(pp: np.ndarray, pc: np.ndarray, tt: np.ndarray, tc: np.ndarray) -> None:
    """Packed-batch invariants for both compute routes (the C++ evaluator and the numpy route).

    Count-range check FIRST: an out-of-range count would make the label bound
    check misread sentinel padding as real labels. The f32-exactness bound runs
    on the already-fetched host buffers (any original id with |v| >= 2**24 lands
    here with |packed| >= 2**24, so detection after the cast is sound; device
    arrays at update time could not be checked without an extra fetch).
    """
    if (pc < 0).any() or (pc > pp.shape[1]).any() or (tc < 0).any() or (tc > tt.shape[1]).any():
        raise ValueError(
            f"Packed num_boxes out of range: counts must lie in [0, padded width]"
            f" ({pp.shape[1]} preds / {tt.shape[1]} target) — a count past the padding"
            " would silently drop boxes"
        )
    _check_packed_label_bound("preds", pp[..., 5], pc)
    _check_packed_label_bound("target", tt[..., 4], tc)


def _f64(arr: np.ndarray) -> np.ndarray:
    """float64 ingestion matching the C++ evaluator (``coco_eval_bbox`` takes
    f64 boxes), so a threshold-straddling IoU cannot flip between the C++ evaluator
    and the numpy route on float32 rounding alone. No copy when the input is already
    f64 — shared by both IoU helpers and the area helper."""
    return arr.astype(np.float64, copy=False)


def _safe_iou(inter: np.ndarray, union: np.ndarray) -> np.ndarray:
    """The shared zero-union guard: pairs with an empty union define IoU as 0
    (degenerate zero-area boxes / empty masks must not divide by zero)."""
    return inter / np.where(union == 0, 1.0, union)


def _np_box_iou(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Host-side pairwise IoU used inside the ragged evaluation loops."""
    if det.size == 0 or gt.size == 0:
        return np.zeros((det.shape[0], gt.shape[0]))
    det = _f64(det)
    gt = _f64(gt)
    area1 = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return _safe_iou(inter, union)


def _np_mask_iou(det, gt) -> np.ndarray:
    """Pairwise mask IoU: dense masks via one flattened matmul, RLEs via the native kernel."""
    if _is_rle_list(det) or _is_rle_list(gt):
        from torchmetrics_tpu_torch.native import rle_encode, rle_iou

        # mixed inputs: encode the dense side so one O(runs) kernel handles the pair
        det_rle = list(det) if _is_rle_list(det) else [rle_encode(m) for m in np.asarray(det)]
        gt_rle = list(gt) if _is_rle_list(gt) else [rle_encode(m) for m in np.asarray(gt)]
        return rle_iou(det_rle, gt_rle)
    if det.size == 0 or gt.size == 0:
        return np.zeros((det.shape[0], gt.shape[0]))
    d = _f64(det.reshape(det.shape[0], -1))
    g = _f64(gt.reshape(gt.shape[0], -1))
    inter = d @ g.T
    union = d.sum(axis=1)[:, None] + g.sum(axis=1)[None, :] - inter
    return _safe_iou(inter, union)


def _is_rle_list(values) -> bool:
    """True for a sequence of COCO-style ``{"size", "counts"}`` RLE dicts."""
    return isinstance(values, (list, tuple)) and (len(values) == 0 or isinstance(values[0], dict))


def _take(values, selector):
    """Row-select that works for both ndarray stacks and RLE lists."""
    if _is_rle_list(values):
        idx = np.flatnonzero(selector) if np.asarray(selector).dtype == bool else np.asarray(selector)
        return [values[i] for i in idx]
    return values[selector]


def _area(values, iou_type: str) -> np.ndarray:
    """Box or mask areas for the ignore-range logic."""
    if _is_rle_list(values):
        from torchmetrics_tpu_torch.native import rle_area

        return np.asarray([rle_area(r) for r in values], dtype=np.float64)
    if values.size == 0:
        return np.zeros((values.shape[0],))
    if iou_type == "bbox":
        # f64 ingestion mirrors the C++ evaluator's area computation, keeping the
        # area-range ignore decisions identical between the two paths
        values = _f64(values)
        return (values[:, 2] - values[:, 0]) * (values[:, 3] - values[:, 1])
    return values.reshape(values.shape[0], -1).sum(axis=1)


class MeanAveragePrecision(Metric):
    """mAP / mAR for object detection with COCOeval semantics.

    Example:
        >>> import torch
        >>> preds = [{'boxes': torch.tensor([[10.0, 10.0, 60.0, 60.0]]), 'scores': torch.tensor([0.9]), 'labels': torch.tensor([0])}]
        >>> target = [{'boxes': torch.tensor([[12.0, 10.0, 58.0, 62.0]]), 'labels': torch.tensor([0])}]
        >>> from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> print(round(float(metric.compute()['map']), 4))
        0.8
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    detections: List[Any]
    detection_scores: List[torch.Tensor]
    detection_labels: List[torch.Tensor]
    groundtruths: List[Any]
    groundtruth_labels: List[torch.Tensor]

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        allowed_iou_types = ("segm", "bbox")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, round((0.95 - 0.5) / 0.05) + 1).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, round(1.00 / 0.01) + 1).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if iou_type not in allowed_iou_types:
            raise ValueError(f"Expected argument `iou_type` to be one of {allowed_iou_types} but got {iou_type}")
        self.iou_type = iou_type
        self.bbox_area_ranges = {
            "all": (float(0**2), float(1e5**2)),
            "small": (float(0**2), float(32**2)),
            "medium": (float(32**2), float(96**2)),
            "large": (float(96**2), float(1e5**2)),
        }

        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics

        self.add_state("detections", default=[], dist_reduce_fx=None)
        self.add_state("detection_scores", default=[], dist_reduce_fx=None)
        self.add_state("detection_labels", default=[], dist_reduce_fx=None)
        self.add_state("groundtruths", default=[], dist_reduce_fx=None)
        self.add_state("groundtruth_labels", default=[], dist_reduce_fx=None)
        # the packed-dict route: one buffer per update call
        self.add_state("packed_preds", default=[], dist_reduce_fx=None)
        self.add_state("packed_pred_counts", default=[], dist_reduce_fx=None)
        self.add_state("packed_targets", default=[], dist_reduce_fx=None)
        self.add_state("packed_target_counts", default=[], dist_reduce_fx=None)

    def update(self, preds: Any, target: Any) -> None:
        """Buffer one batch of predictions and targets.

        Two input forms:

        - sequences of per-image dicts (``boxes`` or ``masks``, ``scores``, ``labels``):
          each image appends one tensor to each of five list states (RLE mask dicts
          stay on the host);
        - packed batches: ``preds = {"boxes": (B, M, 4), "scores": (B, M), "labels":
          (B, M), "num_boxes": (B,)}`` and ``target`` likewise without scores, the padded
          layout a batched NMS produces on the device. One buffer per update whatever
          the batch size (``iou_type="bbox"`` only).
        """
        if isinstance(preds, dict) and isinstance(target, dict):
            self._update_packed(preds, target)
            return
        _input_validator(preds, target, iou_type=self.iou_type)

        for item in preds:
            self.detections.append(self._get_safe_item_values(item))
            self.detection_labels.append(torch.as_tensor(item["labels"], device=self.device))
            self.detection_scores.append(torch.as_tensor(item["scores"], device=self.device))

        for item in target:
            self.groundtruths.append(self._get_safe_item_values(item))
            self.groundtruth_labels.append(torch.as_tensor(item["labels"], device=self.device))

    def _update_packed(self, preds: Dict[str, Any], target: Dict[str, Any]) -> None:
        """Fold a padded batch into single-buffer states.

        Boxes are converted to xyxy and packed with scores and labels into one
        ``(B, M, 6)`` float32 tensor (labels are exact in float32 below 2**24); the valid
        counts ride as ``(B,)`` int32 tensors. Padding rows are never read back:
        ``compute`` slices each image to its count.
        """
        if self.iou_type != "bbox":
            raise ValueError("Packed batch updates support iou_type='bbox' only")
        for name, d, keys in (("preds", preds, ("boxes", "scores", "labels", "num_boxes")),
                              ("target", target, ("boxes", "labels", "num_boxes"))):
            missing = [k for k in keys if k not in d]
            if missing:
                raise ValueError(f"Packed `{name}` dict is missing keys {missing}")
        dev = self.device
        p_boxes = torch.as_tensor(preds["boxes"], dtype=torch.float32, device=dev)
        t_boxes = torch.as_tensor(target["boxes"], dtype=torch.float32, device=dev)
        if p_boxes.ndim != 3 or p_boxes.shape[-1] != 4 or t_boxes.ndim != 3 or t_boxes.shape[-1] != 4:
            raise ValueError(f"Packed boxes must be (B, M, 4), got {tuple(p_boxes.shape)} and {tuple(t_boxes.shape)}")
        if p_boxes.shape[0] != t_boxes.shape[0]:
            raise ValueError("Packed preds and target must share the batch dimension")
        for name, lbl, cnt in (
            ("preds", preds["labels"], preds["num_boxes"]),
            ("target", target["labels"], target["num_boxes"]),
        ):
            # host inputs are checked here, for an early error; device tensors once at
            # compute, on the buffers it reads anyway (no extra device read per update)
            if isinstance(lbl, (np.ndarray, list, tuple)) and isinstance(cnt, (np.ndarray, list, tuple, int)):
                lbl_np = np.asarray(lbl)
                if lbl_np.ndim >= 2:  # malformed shapes fall through to the pack's own checks
                    _check_packed_label_bound(name, lbl_np, np.asarray(cnt))
        p_boxes = _box_convert(p_boxes, in_fmt=self.box_format, out_fmt="xyxy")
        t_boxes = _box_convert(t_boxes, in_fmt=self.box_format, out_fmt="xyxy")
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)[..., None]  # noqa: E731
        self.packed_preds.append(torch.cat([p_boxes, f32(preds["scores"]), f32(preds["labels"])], dim=-1))
        self.packed_pred_counts.append(torch.as_tensor(preds["num_boxes"], dtype=torch.int32, device=dev))
        self.packed_targets.append(torch.cat([t_boxes, f32(target["labels"])], dim=-1))
        self.packed_target_counts.append(torch.as_tensor(target["num_boxes"], dtype=torch.int32, device=dev))

    def _get_safe_item_values(self, item: Dict[str, Any]) -> Any:
        if self.iou_type == "bbox":
            boxes = _fix_empty_tensors(torch.as_tensor(item["boxes"], dtype=torch.float32, device=self.device))
            if boxes.numel() > 0:
                boxes = _box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
            return boxes
        masks = item["masks"]
        if _is_rle_list(masks):
            # COCO-style uncompressed RLE dicts stay on the host (native/rle.cpp)
            return list(masks)
        # dense boolean masks (num_boxes, H, W)
        return torch.as_tensor(masks, device=self.device).to(torch.bool)

    def _host_lists(self) -> Tuple[List[Any], ...]:
        """The per-image list states on the host: one device read per state."""
        return (
            _bulk_to_host(self.detections),
            [np.asarray(s).reshape(-1) for s in _bulk_to_host(self.detection_scores)],
            [lbl.reshape(-1) for lbl in _bulk_to_host(self.detection_labels)],
            _bulk_to_host(self.groundtruths),
            [lbl.reshape(-1) for lbl in _bulk_to_host(self.groundtruth_labels)],
        )

    def _host_packed(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """The packed batches on the host (one device read per state), validated."""
        batches = list(zip(*(_bulk_to_host(s) for s in (
            self.packed_preds, self.packed_pred_counts, self.packed_targets, self.packed_target_counts
        ))))
        for pp, pc, tt, tc in batches:
            _validate_packed_batch(pp, pc, tt, tc)
        return batches

    def _unpack_into(
        self,
        packed: List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
        dets: List[np.ndarray],
        det_scores: List[np.ndarray],
        det_labels: List[np.ndarray],
        gts: List[np.ndarray],
        gt_labels: List[np.ndarray],
    ) -> None:
        """Expand the packed batches into the per-image host lists."""
        for pp, pc, tt, tc in packed:
            for i in range(pp.shape[0]):
                n = int(pc[i])
                dets.append(pp[i, :n, :4].astype(np.float32))
                det_scores.append(pp[i, :n, 4])
                det_labels.append(pp[i, :n, 5].astype(np.int64))
                ng = int(tc[i])
                gts.append(tt[i, :ng, :4].astype(np.float32))
                gt_labels.append(tt[i, :ng, 4].astype(np.int64))

    @staticmethod
    def _get_classes(det_labels: List[np.ndarray], gt_labels: List[np.ndarray]) -> List[int]:
        """Unique classes present in either stream."""
        if len(det_labels) > 0 or len(gt_labels) > 0:
            return np.unique(np.concatenate(det_labels + gt_labels)).astype(int).tolist()
        return []

    # ---------------------------------------------------------------- compute

    def compute(self) -> Dict[str, torch.Tensor]:
        """COCOeval over the buffered epoch, on the host (counted as ``map_host_evals``)."""
        from torchmetrics_tpu_torch.diag import trace
        from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

        with transfer_allowed("map-host-matcher"):
            # the C++ evaluator's interpolation cursor assumes ascending rec_thresholds (the
            # COCO default); anything else takes the per-threshold searchsorted of _calculate
            if self.iou_type == "bbox" and bool(np.all(np.diff(np.asarray(self.rec_thresholds)) >= 0)):
                out = self._compute_native_bbox()
            else:
                dets, det_scores, det_labels, gts, gt_labels = self._host_lists()
                self._unpack_into(self._host_packed(), dets, det_scores, det_labels, gts, gt_labels)
                classes = self._get_classes(det_labels, gt_labels)
                precisions, recalls = self._calculate(classes, dets, det_scores, det_labels, gts, gt_labels)
                out = self._finalize(precisions, recalls, classes)
        # counted once the evaluation ran: the epoch engine's guarded graph attempt at a
        # synced compute stops at the first device read and never gets here
        _STATS.map_host_evals += 1
        trace.record("heavy.fallback", type(self).__name__, label="map-host-matcher", reason="host-route")
        return out

    def _compute_native_bbox(self) -> Dict[str, torch.Tensor]:
        """Epoch-end compute through the C++ evaluator: flat epoch arrays, one call.

        The packed batches are extracted by mask (no per-image slicing); one
        ``coco_eval_bbox`` call buckets, sorts per image, computes the float64 IoU,
        matches and accumulates the PR curves.
        """
        from torchmetrics_tpu_torch.native import coco_eval_bbox

        det_parts, score_parts, dlab_parts, dimg_parts = [], [], [], []
        gt_parts, glab_parts, gimg_parts = [], [], []

        dets_l, scores_l, dlab_l, gts_l, glab_l = self._host_lists()
        n_img = len(gts_l)
        if n_img:
            det_parts += [np.asarray(d).reshape(-1, 4) for d in dets_l]
            score_parts += scores_l
            dlab_parts += dlab_l
            dimg_parts.append(np.repeat(np.arange(n_img), [len(s) for s in dlab_l]))
            gt_parts += [np.asarray(g).reshape(-1, 4) for g in gts_l]
            glab_parts += glab_l
            gimg_parts.append(np.repeat(np.arange(n_img), [len(g) for g in glab_l]))

        for pp, pc, tt, tc in self._host_packed():
            b = pp.shape[0]
            pmask = np.arange(pp.shape[1]) < pc.reshape(-1, 1)
            tmask = np.arange(tt.shape[1]) < tc.reshape(-1, 1)
            det_parts.append(pp[..., :4][pmask])
            score_parts.append(pp[..., 4][pmask])
            dlab_parts.append(pp[..., 5][pmask].astype(np.int64))
            dimg_parts.append(np.broadcast_to((n_img + np.arange(b))[:, None], pmask.shape)[pmask])
            gt_parts.append(tt[..., :4][tmask])
            glab_parts.append(tt[..., 4][tmask].astype(np.int64))
            gimg_parts.append(np.broadcast_to((n_img + np.arange(b))[:, None], tmask.shape)[tmask])
            n_img += b

        cat = lambda parts, empty: np.concatenate(parts) if parts else empty  # noqa: E731
        det_labels = cat(dlab_parts, np.zeros(0, np.int64)).astype(np.int64)
        gt_labels = cat(glab_parts, np.zeros(0, np.int64)).astype(np.int64)
        classes = self._get_classes([det_labels], [gt_labels])
        sorted_ids = np.asarray(classes, dtype=np.int64)
        precisions, recalls = coco_eval_bbox(
            cat(det_parts, np.zeros((0, 4))),
            cat(score_parts, np.zeros(0)),
            cat(dimg_parts, np.zeros(0, np.int64)),
            np.searchsorted(sorted_ids, det_labels),
            cat(gt_parts, np.zeros((0, 4))),
            cat(gimg_parts, np.zeros(0, np.int64)),
            np.searchsorted(sorted_ids, gt_labels),
            n_img,
            len(classes),
            np.asarray(self.iou_thresholds, dtype=np.float64),
            np.asarray(self.rec_thresholds),
            np.asarray(list(self.bbox_area_ranges.values()), dtype=np.float64),
            np.asarray(self.max_detection_thresholds, dtype=np.int64),
        )
        return self._finalize(precisions, recalls, classes)

    def _finalize(self, precisions: np.ndarray, recalls: np.ndarray, classes: List[int]) -> Dict[str, torch.Tensor]:
        """Summarize the precision / recall tensors into the COCO headline dict, on the
        metric's device."""
        map_val, mar_val = self._summarize_results(precisions, recalls)

        map_per_class: Any = np.array([-1.0])
        mar_max_per_class: Any = np.array([-1.0])
        if self.class_metrics:
            map_list, mar_list = [], []
            for class_idx, _ in enumerate(classes):
                cls_prec = precisions[:, :, class_idx][:, :, None]
                cls_rec = recalls[:, class_idx][:, None]
                cls_map, cls_mar = self._summarize_results(cls_prec, cls_rec)
                map_list.append(cls_map["map"])
                mar_list.append(cls_mar[f"mar_{self.max_detection_thresholds[-1]}"])
            map_per_class = np.array(map_list, dtype=np.float32)
            mar_max_per_class = np.array(mar_list, dtype=np.float32)

        host: Dict[str, np.ndarray] = {k: np.asarray(v, np.float32) for k, v in {**map_val, **mar_val}.items()}
        host["map_per_class"] = np.asarray(map_per_class, np.float32).squeeze()
        host[f"mar_{self.max_detection_thresholds[-1]}_per_class"] = np.asarray(mar_max_per_class, np.float32).squeeze()
        # the float32 values reach the device in one copy, the int32 classes in another
        flat = torch.from_numpy(np.concatenate([v.reshape(-1) for v in host.values()])).to(self.device)
        out: Dict[str, torch.Tensor] = {}
        offset = 0
        for k, v in host.items():
            out[k] = flat[offset : offset + v.size].reshape(v.shape)
            offset += v.size
        out["classes"] = torch.from_numpy(np.asarray(classes, np.int32).squeeze()).to(self.device)
        return out

    def _evaluate_pair(
        self,
        idx: int,
        class_id: int,
        max_det: int,
        thresholds: np.ndarray,
        area_ranges: np.ndarray,
        dets: List[np.ndarray],
        det_scores: List[np.ndarray],
        det_labels: List[np.ndarray],
        gts: List[np.ndarray],
        gt_labels: List[np.ndarray],
    ) -> Optional[List[Dict[str, np.ndarray]]]:
        """Evaluate ONE (image, class) across every area range and IoU threshold.

        IoU is computed once (score-sorted rows, truncated to the largest max-det
        threshold); the greedy matching for all areas x thresholds runs in the native
        ``coco_match`` (``native/match.cpp``). Returns one eval dict per area range, or
        None when the class is absent from the image.
        """
        gt_mask = gt_labels[idx] == class_id
        det_mask = det_labels[idx] == class_id
        n_gt = int(gt_mask.sum())
        n_det = int(det_mask.sum())
        if n_gt == 0 and n_det == 0:
            return None

        if n_det:
            scores = det_scores[idx][det_mask]
            order = np.argsort(-scores, kind="stable")[:max_det]
            scores_sorted = scores[order]
            det = _take(_take(dets[idx], det_mask), order)
            det_areas = _area(det, self.iou_type)
        else:
            scores_sorted = np.zeros(0)
            det = None
            det_areas = np.zeros(0)
        if n_gt:
            gt = _take(gts[idx], gt_mask)
            gt_areas = _area(gt, self.iou_type)
        else:
            gt = None
            gt_areas = np.zeros(0)

        if n_det and n_gt:
            iou_mat = _np_box_iou(det, gt) if self.iou_type == "bbox" else _np_mask_iou(det, gt)
        else:
            iou_mat = np.zeros((len(scores_sorted), n_gt))

        from torchmetrics_tpu_torch.native import coco_match

        det_matches, det_ignore, gt_ignore = coco_match(
            iou_mat, det_areas, gt_areas, thresholds, area_ranges
        )
        return [
            {
                "dtMatches": det_matches[a],
                "dtScores": scores_sorted,
                "gtIgnore": gt_ignore[a],
                "dtIgnore": det_ignore[a],
            }
            for a in range(area_ranges.shape[0])
        ]

    def _calculate(
        self,
        class_ids: List[int],
        dets: List[np.ndarray],
        det_scores: List[np.ndarray],
        det_labels: List[np.ndarray],
        gts: List[np.ndarray],
        gt_labels: List[np.ndarray],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Precision/recall accumulation over classes x areas x max-dets.

        COCO-scale design: a per-class image index skips the (image, class) pairs
        where the class appears on neither side — at 5k images x 80 classes that is
        the overwhelming majority — and each surviving pair is evaluated in one
        native-matcher call covering all areas and thresholds.
        """
        nb_imgs = len(gts)
        max_detections = self.max_detection_thresholds[-1]
        thresholds = np.asarray(self.iou_thresholds, dtype=np.float64)
        area_ranges = np.asarray(list(self.bbox_area_ranges.values()), dtype=np.float64)


        class_imgs: Dict[int, List[int]] = {c: [] for c in class_ids}
        for idx in range(nb_imgs):
            for c in np.union1d(det_labels[idx], gt_labels[idx]):
                if (c := int(c)) in class_imgs:
                    class_imgs[c].append(idx)

        nb_iou_thrs = len(self.iou_thresholds)
        nb_rec_thrs = len(self.rec_thresholds)
        nb_classes = len(class_ids)
        nb_areas = len(self.bbox_area_ranges)
        nb_max_det_thrs = len(self.max_detection_thresholds)
        precision = -np.ones((nb_iou_thrs, nb_rec_thrs, nb_classes, nb_areas, nb_max_det_thrs))
        recall = -np.ones((nb_iou_thrs, nb_classes, nb_areas, nb_max_det_thrs))

        rec_thresholds = np.asarray(self.rec_thresholds)

        for idx_cls, class_id in enumerate(class_ids):
            per_area: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(nb_areas)]
            for img_id in class_imgs[class_id]:
                evals = self._evaluate_pair(
                    img_id, class_id, max_detections, thresholds, area_ranges,
                    dets, det_scores, det_labels, gts, gt_labels,
                )
                if evals is None:
                    continue
                for idx_area in range(nb_areas):
                    per_area[idx_area].append(evals[idx_area])
            for idx_area in range(nb_areas):
                if not per_area[idx_area]:
                    continue
                for idx_max_det, max_det in enumerate(self.max_detection_thresholds):
                    self._accumulate(
                        precision, recall, per_area[idx_area], rec_thresholds,
                        idx_cls, idx_area, idx_max_det, max_det,
                    )
        return precision, recall

    def _accumulate(
        self,
        precision: np.ndarray,
        recall: np.ndarray,
        evals: List[Dict[str, np.ndarray]],
        rec_thresholds: np.ndarray,
        idx_cls: int,
        idx_area: int,
        idx_max_det: int,
        max_det: int,
    ) -> None:
        """PR curve for one (class, area, max_det) cell."""
        det_scores = np.concatenate([e["dtScores"][:max_det] for e in evals])
        # stable descending sort keeps COCO/Matlab tie order
        inds = np.argsort(-det_scores, kind="stable")
        det_scores_sorted = det_scores[inds]

        det_matches = np.concatenate([e["dtMatches"][:, :max_det] for e in evals], axis=1)[:, inds]
        det_ignore = np.concatenate([e["dtIgnore"][:, :max_det] for e in evals], axis=1)[:, inds]
        gt_ignore = np.concatenate([e["gtIgnore"] for e in evals])
        npig = int((~gt_ignore).sum())
        if npig == 0:
            return
        tps = det_matches & ~det_ignore
        fps = ~det_matches & ~det_ignore

        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
        nb_rec_thrs = len(rec_thresholds)

        for idx_iou, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.finfo(np.float64).eps)
            recall[idx_iou, idx_cls, idx_area, idx_max_det] = rc[-1] if nd else 0

            # monotone envelope removes PR zigzags before interpolation
            pr = np.maximum.accumulate(pr[::-1])[::-1]

            inds_rec = np.searchsorted(rc, rec_thresholds, side="left")
            prec_at = np.zeros((nb_rec_thrs,))
            num_inds = int(inds_rec.argmax()) if inds_rec.max(initial=0) >= nd else nb_rec_thrs
            valid = inds_rec[:num_inds]
            prec_at[:num_inds] = pr[valid]
            precision[idx_iou, :, idx_cls, idx_area, idx_max_det] = prec_at

    def _summarize(
        self,
        results: Dict[str, np.ndarray],
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> np.ndarray:
        """Mean of the selected precision/recall cells, -1 when empty."""
        area_inds = [i for i, k in enumerate(self.bbox_area_ranges.keys()) if k == area_range]
        mdet_inds = [i for i, k in enumerate(self.max_detection_thresholds) if k == max_dets]
        if avg_prec:
            prec = results["precision"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, :, area_inds, mdet_inds]
        else:
            prec = results["recall"]
            if iou_threshold is not None:
                thr = self.iou_thresholds.index(iou_threshold)
                prec = prec[thr, :, area_inds, mdet_inds]
            else:
                prec = prec[:, :, area_inds, mdet_inds]
        valid = prec[prec > -1]
        return np.array(-1.0) if valid.size == 0 else valid.mean()

    def _summarize_results(
        self, precisions: np.ndarray, recalls: np.ndarray
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """The standard COCO headline numbers."""
        results = {"precision": precisions, "recall": recalls}
        last_max_det = self.max_detection_thresholds[-1]
        map_val = {
            "map": self._summarize(results, True, max_dets=last_max_det),
            "map_50": (
                self._summarize(results, True, iou_threshold=0.5, max_dets=last_max_det)
                if 0.5 in self.iou_thresholds
                else np.array(-1.0)
            ),
            "map_75": (
                self._summarize(results, True, iou_threshold=0.75, max_dets=last_max_det)
                if 0.75 in self.iou_thresholds
                else np.array(-1.0)
            ),
            "map_small": self._summarize(results, True, area_range="small", max_dets=last_max_det),
            "map_medium": self._summarize(results, True, area_range="medium", max_dets=last_max_det),
            "map_large": self._summarize(results, True, area_range="large", max_dets=last_max_det),
        }
        mar_val = {f"mar_{max_det}": self._summarize(results, False, max_dets=max_det)
                   for max_det in self.max_detection_thresholds}
        mar_val["mar_small"] = self._summarize(results, False, area_range="small", max_dets=last_max_det)
        mar_val["mar_medium"] = self._summarize(results, False, area_range="medium", max_dets=last_max_det)
        mar_val["mar_large"] = self._summarize(results, False, area_range="large", max_dets=last_max_det)
        return map_val, mar_val

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
