"""In-graph packed-route mean average precision: the mAP path that runs on the card
(counterpart of ``torchmetrics_tpu/detection/ingraph.py``).

:class:`~torchmetrics_tpu_torch.detection.mean_ap.MeanAveragePrecision` matches on the
host. This module evaluates the *packed* layout (the padded ``(B, M, ...)`` tensors a
batched NMS produces on the device) in plain PyTorch that reads nothing back, so the
compiled update engine captures one update as one CUDA graph and replays it:

- **Padded per-image IoU**: one broadcast ``(B, M, G)`` pairwise IoU in float64,
  label-masked so every class evaluates in the same pass.
- **Greedy assignment**: detections walk in stable score order for M steps, vectorised
  over the batch; each step picks, by a first-index argmax, the best still-unmatched,
  non-ignored ground truth for every IoU threshold and area range at once. The rules
  are the host matcher's (``native/match.cpp:coco_match``): strict ``IoU > thr``,
  non-ignored ground truths only, ties to the lowest index.
- **PR accumulation as histogram states**: every detection adds its TP / FP verdict to
  fixed-shape per-``(class, threshold, area, maxdet)`` score histograms (``score_bins``
  bins over [0, 1]) with a float32 ``index_add_`` of 0 / 1 values, exact below 2**24.
  ``compute`` rebuilds the PR curves from the reversed cumulative histograms; it is exact
  when distinct scores land in distinct bins and within the bin width otherwise.

The states are sum-folded fixed-shape tensors, so the metric rides the engine like a
counter: CUDA-graph replays, power-of-two batch buckets (``_engine_row_additive``: a
zero-count pad image adds exactly zero), the scan queue and async drains.

Known deltas against the host route, by construction: ``classes`` is the whole
configured ``[0, num_classes)`` range (absent classes are ``-1`` in every cell and drop
out of every mean, as on the host), and per-class arrays have ``num_classes`` entries.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.engine import bucketing
from torchmetrics_tpu_torch.functional.detection.helpers import _box_convert, _box_iou
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel.sharding import local_block

#: the host evaluator's epsilon in the precision denominator
_PR_EPS = float(np.finfo(np.float64).eps)


class _MapParams(NamedTuple):
    """Static evaluation grid: hashable, the key of its device constants."""

    num_classes: int
    iou_thresholds: Tuple[float, ...]
    rec_thresholds: Tuple[float, ...]
    max_dets: Tuple[int, ...]
    area_ranges: Tuple[Tuple[float, float], ...]
    score_bins: int


class _Grid(NamedTuple):
    """A grid's tensors on one device."""

    thr: torch.Tensor  # (T,) float64
    lo: torch.Tensor  # (A,) float64
    hi: torch.Tensor  # (A,) float64
    max_dets: torch.Tensor  # (Md,) int64
    rec: torch.Tensor  # (R,) float64


_GRIDS: Dict[Tuple[_MapParams, torch.device], _Grid] = {}


def _grid(params: _MapParams, device: torch.device) -> _Grid:
    """``params``' tensors on ``device``, made once. A metric makes its grid when it is
    built or moved, so an update or compute under the engine's guard (which refuses host
    data) only finds it."""
    key = (params, device)
    grid = _GRIDS.get(key)
    if grid is None:
        f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=device)  # noqa: E731
        areas = np.asarray(params.area_ranges, dtype=np.float64).reshape(-1, 2)
        grid = _GRIDS[key] = _Grid(
            thr=f64(params.iou_thresholds),
            lo=f64(areas[:, 0].tolist()),
            hi=f64(areas[:, 1].tolist()),
            max_dets=torch.tensor(params.max_dets, dtype=torch.int64, device=device),
            rec=f64(params.rec_thresholds),
        )
    return grid


def _device_key(device: torch.device) -> torch.device:
    """The device a tensor made on ``device`` reports (``cuda`` gains its index)."""
    return torch.empty(0, device=device).device


def _image_eval(pp: torch.Tensor, n_p: torch.Tensor, tt: torch.Tensor, n_t: torch.Tensor, params: _MapParams):
    """Match a batch of padded images; per-detection verdicts and per-class GT counts.

    Follows ``coco_match``'s plain version: detections in stable score-descending
    order, first-index argmax over the valid same-class ground truths that are neither
    matched nor area-ignored, strict ``IoU > thr``. Vectorised over the batch: B
    images, M detection slots, G ground-truth slots; T thresholds, A area ranges.
    """
    grid = _grid(params, pp.device)
    C = params.num_classes
    T, A = grid.thr.shape[0], grid.lo.shape[0]
    B, M, G = pp.shape[0], pp.shape[1], tt.shape[1]

    boxes_d = pp[..., :4].to(torch.float64)
    scores = pp[..., 4]
    labels_d = pp[..., 5].to(torch.int32)
    boxes_g = tt[..., :4].to(torch.float64)
    labels_g = tt[..., 4].to(torch.int32)

    slot_d = torch.arange(M, device=pp.device)
    slot_g = torch.arange(G, device=pp.device)
    vd = (slot_d[None, :] < n_p[:, None]) & (labels_d >= 0) & (labels_d < C)  # (B, M)
    vg = (slot_g[None, :] < n_t[:, None]) & (labels_g >= 0) & (labels_g < C)  # (B, G)

    area_d = (boxes_d[..., 2] - boxes_d[..., 0]) * (boxes_d[..., 3] - boxes_d[..., 1])
    area_g = (boxes_g[..., 2] - boxes_g[..., 0]) * (boxes_g[..., 3] - boxes_g[..., 1])
    lo, hi = grid.lo[None, :, None], grid.hi[None, :, None]
    gt_ignore = (area_g[:, None, :] < lo) | (area_g[:, None, :] > hi)  # (B, A, G)
    det_oor = (area_d[:, None, :] < lo) | (area_d[:, None, :] > hi)  # (B, A, M)

    # per-class score rank (stable descending, row order breaking ties): the host
    # route's per-(image, class) truncation to the largest max-det
    better = (scores[:, None, :] > scores[:, :, None]) | (
        (scores[:, None, :] == scores[:, :, None]) & (slot_d[None, :] < slot_d[:, None])
    )
    same_cls = labels_d[:, None, :] == labels_d[:, :, None]
    rank = (better & same_cls & vd[:, None, :]).sum(dim=2)  # (B, M)
    participate = vd & (rank < int(params.max_dets[-1]))

    det_match = torch.zeros((B, M, T, A), dtype=torch.bool, device=pp.device)
    if G > 0 and M > 0:
        pair_ok = vd[:, :, None] & vg[:, None, :] & (labels_d[:, :, None] == labels_g[:, None, :])
        iou = torch.where(pair_ok, _box_iou(boxes_d, boxes_g), 0.0)  # (B, M, G) float64
        order = torch.argsort(-scores, dim=1, stable=True)  # equal scores keep row order
        allowed_base = (~gt_ignore)[:, None, :, :] & vg[:, None, None, :]  # (B, 1, A, G)
        thr = grid.thr[None, :, None]
        matched = torch.zeros((B, T, A, G), dtype=torch.bool, device=pp.device)
        for k in range(M):
            d = order[:, k]  # (B,)
            row = iou.gather(1, d[:, None, None].expand(B, 1, G))  # (B, 1, G)
            masked = torch.where(allowed_base & ~matched, row[:, :, None, :], 0.0)  # (B, T, A, G)
            g_best = masked.argmax(dim=-1)  # (B, T, A): the first maximum
            v_best = masked.gather(-1, g_best[..., None])[..., 0]
            hit = participate.gather(1, d[:, None])[:, :, None] & (v_best > thr)  # (B, T, A)
            matched = matched | ((slot_g == g_best[..., None]) & hit[..., None])
            det_match.scatter_(1, d[:, None, None, None].expand(B, 1, T, A), hit[:, None])

    det_ign = ~det_match & det_oor.transpose(1, 2)[:, :, None, :]  # (B, M, T, A)
    incl = participate[..., None] & (rank[..., None] < grid.max_dets)  # (B, M, Md)
    tp = det_match & ~det_ign  # matched detections are never ignored; kept for clarity
    fp = ~det_match & ~det_ign
    nb = params.score_bins
    bins = (scores * nb).to(torch.int32).clamp(0, nb - 1)

    onehot_g = ((labels_g[..., None] == torch.arange(C, device=pp.device)) & vg[..., None]).to(torch.float64)
    n_pos = torch.matmul((~gt_ignore).to(torch.float64), onehot_g).transpose(1, 2)  # (B, C, A)
    return tp, fp, incl, bins, labels_d, n_pos


def packed_contributions(
    packed_preds: torch.Tensor,
    pred_counts: torch.Tensor,
    packed_targets: torch.Tensor,
    target_counts: torch.Tensor,
    params: _MapParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one padded batch into ``(tp_hist, fp_hist, n_pos)`` deltas.

    Additive over the batch dimension (each image contributes on its own), so the
    engine's pad-subtract bucketing identity holds: a zero-count pad image contributes
    exactly zero to every state.
    """
    C, nb = params.num_classes, params.score_bins
    T, A, Md = len(params.iou_thresholds), len(params.area_ranges), len(params.max_dets)
    dev = packed_preds.device

    tp, fp, incl, bins, cls, n_pos = _image_eval(packed_preds, pred_counts, packed_targets, target_counts, params)

    # every (image, det, threshold, area, maxdet) verdict goes into one scatter-add over
    # the flat histogram; invalid detections carry 0
    val_tp = (tp[..., None] & incl[:, :, None, None, :]).to(torch.float32)  # (B, M, T, A, Md)
    val_fp = (fp[..., None] & incl[:, :, None, None, :]).to(torch.float32)
    c = cls.clamp(0, C - 1).to(torch.int64)[:, :, None, None, None]
    ti = torch.arange(T, device=dev)[None, None, :, None, None]
    ai = torch.arange(A, device=dev)[None, None, None, :, None]
    mi = torch.arange(Md, device=dev)[None, None, None, None, :]
    b = bins.to(torch.int64)[:, :, None, None, None]
    idx = ((((c * T + ti) * A + ai) * Md + mi) * nb + b).reshape(-1)
    flat = C * T * A * Md * nb
    tp_hist = torch.zeros(flat, dtype=torch.float32, device=dev).index_add_(0, idx, val_tp.reshape(-1))
    fp_hist = torch.zeros(flat, dtype=torch.float32, device=dev).index_add_(0, idx, val_fp.reshape(-1))
    shape = (C, T, A, Md, nb)
    return tp_hist.reshape(shape), fp_hist.reshape(shape), n_pos.sum(dim=0).to(torch.float32)


def _masked_mean(x: torch.Tensor, dims: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Mean over the cells > -1 (over ``dims``, or all), or -1 where there are none: the
    host ``_summarize`` rule."""
    dims = tuple(range(x.ndim)) if dims is None else dims
    valid = x > -1
    count = valid.sum(dim=dims)
    total = torch.where(valid, x, 0.0).sum(dim=dims)
    return torch.where(count > 0, total / count.clamp(min=1), -1.0).to(torch.float32)


def compute_from_hists(
    tp_hist: torch.Tensor, fp_hist: torch.Tensor, n_pos: torch.Tensor, params: _MapParams
) -> Dict[str, torch.Tensor]:
    """The COCO headline dict from the histogram states, with no host read.

    The reversed-bin cumulative sum is the score-descending TP / FP accumulation of the
    host ``_accumulate``; the monotone envelope and the recall-threshold interpolation
    follow the same rules (``searchsorted`` left, precision 0 past the recall reached,
    cells -1 where ``n_pos`` is 0). Float64 throughout.
    """
    C, nb = params.num_classes, params.score_bins
    Md = len(params.max_dets)
    rec_t = _grid(params, tp_hist.device).rec

    tp_cum = torch.cumsum(tp_hist.flip(-1).to(torch.float64), dim=-1)  # (C, T, A, Md, NB)
    fp_cum = torch.cumsum(fp_hist.flip(-1).to(torch.float64), dim=-1)
    npig = n_pos.to(torch.float64)[:, None, :, None]  # (C, 1, A, 1)
    cell_ok = npig > 0
    rc = tp_cum / npig[..., None].clamp(min=1.0)
    pr = tp_cum / (tp_cum + fp_cum + _PR_EPS)
    # monotone envelope: the suffix running max (the host's maximum.accumulate reversed)
    pr_env = torch.cummax(pr.flip(-1), dim=-1).values.flip(-1)

    # per-cell searchsorted (left) at the recall thresholds, batched over the cells
    cells = rc.reshape(-1, nb)
    idx = torch.searchsorted(cells, rec_t.expand(cells.shape[0], -1).contiguous(), side="left")
    idx = idx.reshape(*rc.shape[:-1], rec_t.shape[0])  # (C, T, A, Md, R)
    prec_at = torch.where(idx < nb, pr_env.gather(-1, idx.clamp(max=nb - 1)), 0.0)
    precision = torch.where(cell_ok[..., None], prec_at, -1.0)  # (C, T, A, Md, R)
    recall = torch.where(cell_ok, tp_cum[..., -1] / npig.clamp(min=1.0), -1.0)  # (C, T, A, Md)

    last = Md - 1
    iou_list = list(params.iou_thresholds)
    out: Dict[str, torch.Tensor] = {
        "map": _masked_mean(precision[:, :, 0, last, :]),
        "map_small": _masked_mean(precision[:, :, 1, last, :]),
        "map_medium": _masked_mean(precision[:, :, 2, last, :]),
        "map_large": _masked_mean(precision[:, :, 3, last, :]),
    }
    for key, value in (("map_50", 0.5), ("map_75", 0.75)):
        out[key] = (
            _masked_mean(precision[:, iou_list.index(value), 0, last, :])
            if value in iou_list
            else torch.full((), -1.0, device=tp_hist.device)
        )
    for mi, max_det in enumerate(params.max_dets):
        out[f"mar_{max_det}"] = _masked_mean(recall[:, :, 0, mi])
    out["mar_small"] = _masked_mean(recall[:, :, 1, last])
    out["mar_medium"] = _masked_mean(recall[:, :, 2, last])
    out["mar_large"] = _masked_mean(recall[:, :, 3, last])
    out["map_per_class"] = _masked_mean(precision[:, :, 0, last, :], dims=(1, 2))
    out[f"mar_{params.max_dets[-1]}_per_class"] = _masked_mean(recall[:, :, 0, last], dims=(1,))
    out["classes"] = torch.arange(C, dtype=torch.int32, device=tp_hist.device)
    return out


class PackedMeanAveragePrecision(Metric):
    """mAP / mAR over padded detection batches, evaluated on the metric's device.

    The engine-native sibling of :class:`~torchmetrics_tpu_torch.detection.mean_ap.
    MeanAveragePrecision` for the packed layout: ``update`` folds greedy matching and PR
    accumulation into fixed-shape histogram states with no host read (one CUDA graph
    replay per update under the engine); ``compute`` rebuilds the COCO headline numbers
    from the histograms. Needs ``num_classes`` up front (fixed state shapes) and scores
    in ``[0, 1]``. Under a state mesh the three states split their class axis
    (``class_axis``, ``parallel/sharding.py``).

    Args:
        num_classes: class-id range ``[0, num_classes)``; labels outside it count as padding.
        box_format: input box convention (converted on the device when not xyxy).
        iou_thresholds / rec_thresholds / max_detection_thresholds /
        class_metrics: as in :class:`MeanAveragePrecision`.
        score_bins: PR histogram resolution over [0, 1]; the curve is exact when
            distinct scores land in distinct bins.

    :meth:`update_batch` takes the dict schema of the host packed route and pads the
    detection-slot dimensions to power-of-two widths (few graph signatures across
    ragged batches); the batch dimension rides the engine's own buckets.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PackedMeanAveragePrecision
        >>> preds = {"boxes": torch.tensor([[[10.0, 10.0, 60.0, 60.0]]]), "scores": torch.tensor([[0.9]]),
        ...          "labels": torch.tensor([[0]]), "num_boxes": torch.tensor([1])}
        >>> target = {"boxes": torch.tensor([[[12.0, 10.0, 58.0, 62.0]]]), "labels": torch.tensor([[0]]),
        ...           "num_boxes": torch.tensor([1])}
        >>> metric = PackedMeanAveragePrecision(num_classes=2, device="cpu")
        >>> metric.update_batch(preds, target)
        >>> print(round(float(metric.compute()["map"]), 4))
        0.8
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    # additive over batch images with sum states: bucketing, scan and async compose
    # like any counter metric (a count-0 pad image contributes zero)
    _engine_row_additive: bool = True
    # placement (parallel/sharding.py): the class dim leads every state, so a
    # large-vocabulary detector's histograms split over the state mesh like any counter
    _engine_shard_rules = {
        "map_tp_hist": "class_axis",
        "map_fp_hist": "class_axis",
        "map_n_pos": "class_axis",
    }

    def __init__(
        self,
        num_classes: int,
        box_format: str = "xyxy",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        score_bins: int = 1024,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"Expected `num_classes` to be a positive int, got {num_classes!r}")
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected `box_format` to be one of ('xyxy', 'xywh', 'cxcywh'), got {box_format}")
        if not isinstance(score_bins, int) or score_bins < 2:
            raise ValueError(f"Expected `score_bins` to be an int >= 2, got {score_bins!r}")
        self.box_format = box_format
        self.class_metrics = bool(class_metrics)
        iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, round((0.95 - 0.5) / 0.05) + 1).tolist()
        rec_thresholds = rec_thresholds or np.linspace(0.0, 1.00, round(1.00 / 0.01) + 1).tolist()
        max_dets = sorted(max_detection_thresholds or [1, 10, 100])
        # the host route's bbox_area_ranges, in the same order
        area_ranges = (
            (float(0**2), float(1e5**2)),
            (float(0**2), float(32**2)),
            (float(32**2), float(96**2)),
            (float(96**2), float(1e5**2)),
        )
        self._params = _MapParams(
            num_classes=num_classes,
            iou_thresholds=tuple(float(x) for x in iou_thresholds),
            rec_thresholds=tuple(float(x) for x in rec_thresholds),
            max_dets=tuple(int(x) for x in max_dets),
            area_ranges=area_ranges,
            score_bins=score_bins,
        )
        _grid(self._params, _device_key(self.device))
        C, T, A, Md = num_classes, len(iou_thresholds), len(area_ranges), len(max_dets)
        hist = (C, T, A, Md, score_bins)
        self.add_state("map_tp_hist", torch.zeros(hist, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("map_fp_hist", torch.zeros(hist, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("map_n_pos", torch.zeros((C, A), dtype=torch.float32), dist_reduce_fx="sum")

    def to(self, device: Any) -> "PackedMeanAveragePrecision":  # type: ignore[override]
        super().to(device)
        _grid(self._params, _device_key(self.device))
        return self

    def update(
        self,
        packed_preds: torch.Tensor,
        pred_counts: torch.Tensor,
        packed_targets: torch.Tensor,
        target_counts: torch.Tensor,
    ) -> None:
        """Fold one padded batch: ``(B, M, 6)`` preds and ``(B, G, 5)`` targets.

        The channels are the host packed route's: preds ``[x1, y1, x2, y2, score,
        label]``, targets ``[x1, y1, x2, y2, label]``; ``counts`` mark each image's valid
        prefix of slots. Nothing is read back, so the engine captures it.
        """
        pp = packed_preds.to(torch.float32)
        tt = packed_targets.to(torch.float32)
        if self.box_format != "xyxy":
            pp = torch.cat([_box_convert(pp[..., :4], in_fmt=self.box_format, out_fmt="xyxy"), pp[..., 4:]], dim=-1)
            tt = torch.cat([_box_convert(tt[..., :4], in_fmt=self.box_format, out_fmt="xyxy"), tt[..., 4:]], dim=-1)
        tp, fp, n_pos = packed_contributions(
            pp, pred_counts.to(torch.int32), tt, target_counts.to(torch.int32), self._params
        )
        self.map_tp_hist = self.map_tp_hist + local_block(self, "map_tp_hist", tp)
        self.map_fp_hist = self.map_fp_hist + local_block(self, "map_fp_hist", fp)
        self.map_n_pos = self.map_n_pos + local_block(self, "map_n_pos", n_pos)

    def update_batch(self, preds: Dict[str, Any], target: Dict[str, Any]) -> None:
        """Dict-schema convenience: pack, widen the slot dimensions, then ``update``.

        Takes the host packed route's schema (``boxes`` / ``scores`` / ``labels`` /
        ``num_boxes``) and pads the slot dimensions to the next power-of-two bucket, so
        ragged widths share O(log M) graph signatures.
        """
        self.update(*pack_detections(preds, target))

    def compute(self) -> Dict[str, torch.Tensor]:
        """The COCO headline dict from the histogram states."""
        out = compute_from_hists(self.map_tp_hist, self.map_fp_hist, self.map_n_pos, self._params)
        if not self.class_metrics:
            dev = self.map_n_pos.device
            out["map_per_class"] = torch.full((), -1.0, device=dev)
            out[f"mar_{self._params.max_dets[-1]}_per_class"] = torch.full((), -1.0, device=dev)
        return out

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


def pack_detections(
    preds: Dict[str, Any], target: Dict[str, Any], min_bucket: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the dict schema into padded tensors with power-of-two slot widths.

    Host inputs are validated as on the host route (count range first, then the float32
    label exactness bound, then scores in [0, 1]); the added pad slots carry label
    ``-1``, so they never alias class 0, and no count covers them. Tensors stay on the
    device they came on.
    """
    from torchmetrics_tpu_torch.detection.mean_ap import _check_packed_label_bound

    for name, d, keys in (
        ("preds", preds, ("boxes", "scores", "labels", "num_boxes")),
        ("target", target, ("boxes", "labels", "num_boxes")),
    ):
        missing = [k for k in keys if k not in d]
        if missing:
            raise ValueError(f"Packed `{name}` dict is missing keys {missing}")
        lbl, cnt = d["labels"], d["num_boxes"]
        if isinstance(lbl, (np.ndarray, list, tuple)) and isinstance(cnt, (np.ndarray, list, tuple, int)):
            lbl_np = np.asarray(lbl)
            if lbl_np.ndim >= 2:
                # the count range first: an out-of-range count would make the label
                # bound check, and the valid-slot masks, read padding as real boxes
                cnt_np = np.asarray(cnt)
                if (cnt_np < 0).any() or (cnt_np > lbl_np.shape[-1]).any():
                    raise ValueError(
                        f"Packed `{name}` num_boxes out of range: counts must lie in"
                        f" [0, slot width] ({lbl_np.shape[-1]}) — a count past the"
                        " padding would silently count pad slots as real boxes"
                    )
                _check_packed_label_bound(name, lbl_np, cnt_np)

    # the PR histograms bin scores over [0, 1]: raw logits would collapse into the end
    # bins; host inputs are checked here, device tensors carry the documented contract
    scores = preds["scores"]
    if isinstance(scores, (np.ndarray, list, tuple)) and isinstance(preds["num_boxes"], (np.ndarray, list, tuple, int)):
        s = np.asarray(scores, dtype=np.float64)
        if s.ndim == 2:
            valid = np.arange(s.shape[-1]) < np.asarray(preds["num_boxes"]).reshape(-1, 1)
            checked = s[valid]
            if checked.size and (float(checked.min()) < 0.0 or float(checked.max()) > 1.0):
                raise ValueError(
                    f"Packed scores must lie in [0, 1] (got [{float(checked.min())}, {float(checked.max())}]):"
                    " the PR histograms bin over the unit interval — apply a sigmoid or a"
                    " normalization before packing"
                )

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    p_boxes, t_boxes = f32(preds["boxes"]), f32(target["boxes"])
    if p_boxes.ndim != 3 or p_boxes.shape[-1] != 4 or t_boxes.ndim != 3 or t_boxes.shape[-1] != 4:
        raise ValueError(f"Packed boxes must be (B, M, 4), got {tuple(p_boxes.shape)} and {tuple(t_boxes.shape)}")
    if p_boxes.shape[0] != t_boxes.shape[0]:
        raise ValueError("Packed preds and target must share the batch dimension")
    dev = p_boxes.device
    pp = torch.cat([p_boxes, f32(preds["scores"]).to(dev)[..., None], f32(preds["labels"]).to(dev)[..., None]], dim=-1)
    tt = torch.cat([t_boxes.to(dev), f32(target["labels"]).to(dev)[..., None]], dim=-1)

    def widen(arr: torch.Tensor) -> torch.Tensor:
        m = arr.shape[1]
        b = bucketing.next_bucket(max(m, 1), min_bucket)
        if b == m:
            return arr
        pad = torch.zeros((arr.shape[0], b - m, arr.shape[2]), dtype=arr.dtype, device=arr.device)
        pad[..., -1] = -1.0  # pad slots get label -1, never a valid class
        return torch.cat([arr, pad], dim=1)

    counts = lambda x: torch.as_tensor(x, dtype=torch.int32).to(dev)  # noqa: E731
    return widen(pp), counts(preds["num_boxes"]), widen(tt), counts(target["num_boxes"])
