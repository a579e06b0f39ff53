"""The port's mean average precision against the JAX package, on the CPU.

- ``MeanAveragePrecision``: the port's public ``compute()`` against the JAX object's two
  evaluators, ``_compute_native_bbox()`` (the C++ epoch evaluator) and ``_calculate`` +
  ``_finalize`` (the per-(image, class) matcher route; the JAX ``compute`` itself stops
  at ``jax.core.trace_state_clean``, which jax 0.9 lacks). Values must be equal, the
  ``classes`` exactly. Box formats, class metrics, custom and non-ascending recall
  thresholds, dense and RLE ``segm``, empty / ground-truth-only / false-positive-only
  images, the packed-dict route and its validation errors, and the number of device
  reads of a ``compute``.
- ``PackedMeanAveragePrecision`` (the in-graph route): ``packed_contributions`` states
  exactly equal to the JAX package's, ``compute_from_hists`` within 1e-6, ragged widths
  through ``pack_detections``, the engine run bit-equal to the eager one with no
  fallback.
- Sync over two gloo ranks: the packed-dict and packed routes equal to one process over
  all the images; ragged per-image lists raise on both ranks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu.detection.ingraph as jingraph
import torchmetrics_tpu_torch.detection.ingraph as tingraph
from torchmetrics_tpu.detection import MeanAveragePrecision as JMAP
from torchmetrics_tpu_torch.detection import MeanAveragePrecision as TMAP
from torchmetrics_tpu_torch.detection import PackedMeanAveragePrecision
from torchmetrics_tpu_torch.detection import mean_ap as tmean_ap
from torchmetrics_tpu_torch.engine import engine_context
from torchmetrics_tpu_torch.native import rle_mask

from tests.test_torch_sync_guard import run_two_ranks

# the detections and ground truths of one COCO-like epoch, made by numpy from a seed;
# exec'd here and in the spawned ranks of the sync tests
_DATA = '''
import numpy as np


def coco_like(seed, n_images=40, n_classes=6, max_gt=6, max_fp=4, empty_every=9):
    """Per-image (boxes xyxy, scores, labels) and (boxes, labels): ground truths of every
    COCO size, detections jittered from them at a spread of IoU plus false positives.
    Every ``empty_every``-th image is empty, the next one has ground truths only and the
    one after that detections only."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n_images):
        g = 0 if i % empty_every in (0, 2) else rng.randint(1, max_gt + 1)
        side = np.exp(rng.uniform(np.log(6.0), np.log(300.0), (g, 2)))
        xy = rng.rand(g, 2) * 400
        gt = np.concatenate([xy, xy + side], 1)
        gl = rng.randint(0, n_classes, g)
        keep = rng.rand(g) < 0.85
        det = gt[keep] + rng.randn(int(keep.sum()), 4) * side[keep].repeat(2, 1) * rng.uniform(0.01, 0.12, (int(keep.sum()), 1))
        dl = np.where(rng.rand(int(keep.sum())) < 0.9, gl[keep], rng.randint(0, n_classes, int(keep.sum())))
        nfp = 0 if i % empty_every in (0, 1) else rng.randint(0, max_fp + 1)
        fxy = rng.rand(nfp, 2) * 400
        fp = np.concatenate([fxy, fxy + np.exp(rng.uniform(np.log(6.0), np.log(200.0), (nfp, 2)))], 1)
        if i % empty_every in (0, 1):
            det, dl = det[:0], dl[:0]
        boxes = np.concatenate([det, fp]).astype(np.float32).reshape(-1, 4)
        labels = np.concatenate([dl, rng.randint(0, n_classes, nfp)]).astype(np.int64)
        scores = np.concatenate([rng.uniform(0.3, 1.0, len(det)), rng.uniform(0.0, 0.7, nfp)]).astype(np.float32)
        preds.append({"boxes": boxes, "scores": scores, "labels": labels})
        target.append({"boxes": gt.astype(np.float32).reshape(-1, 4), "labels": gl.astype(np.int64)})
    return preds, target


def pack(preds, target, width=12, gt_width=8):
    """The images as one packed dict batch of fixed slot widths."""
    b = len(preds)
    pb = np.zeros((b, width, 4), np.float32); ps = np.zeros((b, width), np.float32)
    pl = np.zeros((b, width), np.int64); pc = np.zeros(b, np.int32)
    tb = np.zeros((b, gt_width, 4), np.float32); tl = np.zeros((b, gt_width), np.int64); tc = np.zeros(b, np.int32)
    for i, (p, t) in enumerate(zip(preds, target)):
        n, g = min(len(p["scores"]), width), min(len(t["labels"]), gt_width)
        pb[i, :n], ps[i, :n], pl[i, :n], pc[i] = p["boxes"][:n], p["scores"][:n], p["labels"][:n], n
        tb[i, :g], tl[i, :g], tc[i] = t["boxes"][:g], t["labels"][:g], g
    return ({"boxes": pb, "scores": ps, "labels": pl, "num_boxes": pc},
            {"boxes": tb, "labels": tl, "num_boxes": tc})
'''
_NS: dict = {}
exec(_DATA, _NS)
coco_like, pack = _NS["coco_like"], _NS["pack"]


def _to_format(boxes: np.ndarray, fmt: str) -> np.ndarray:
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    if fmt == "xywh":
        return np.stack([x1, y1, x2 - x1, y2 - y1], 1).astype(np.float32)
    if fmt == "cxcywh":
        return np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], 1).astype(np.float32)
    return boxes


def _torch(items):
    return [{k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v for k, v in d.items()} for d in items]


def _np_out(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_calculate(m: JMAP) -> dict:
    """The JAX package's matcher route on its own states (``compute`` minus its first line)."""
    host = lambda xs: [x if isinstance(x, list) else np.asarray(x) for x in xs]  # noqa: E731
    dets, scores = host(m.detections), host(m.detection_scores)
    dl = [np.asarray(x).reshape(-1) for x in m.detection_labels]
    gts = host(m.groundtruths)
    gl = [np.asarray(x).reshape(-1) for x in m.groundtruth_labels]
    m._unpack_into(dets, scores, dl, gts, gl)
    classes = m._get_classes(dl, gl)
    precision, recall = m._calculate(classes, dets, scores, dl, gts, gl)
    return _np_out(m._finalize(precision, recall, classes))


def _assert_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, (k, g.dtype, want[k].dtype, g.shape)
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def _pair(kwargs: dict, preds, target, packed=()):
    j, t = JMAP(**kwargs), TMAP(device="cpu", **kwargs)
    if preds:
        j.update(preds, target)
        t.update(_torch(preds), _torch(target))
    for p, g in packed:
        j.update(p, g)
        t.update({k: torch.from_numpy(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in g.items()})
    return j, t


# ------------------------------------------------------------------ list route


@pytest.mark.parametrize("box_format", ["xyxy", "xywh", "cxcywh"])
@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_equals_both_jax_evaluators(seed, box_format):
    preds, target = coco_like(seed)
    for d in (*preds, *target):
        d["boxes"] = _to_format(d["boxes"], box_format)
    j, t = _pair({"box_format": box_format, "class_metrics": True}, preds, target)
    got = t.compute()
    native = _np_out(j._compute_native_bbox())
    _assert_equal(got, native)
    _assert_equal(got, _jax_calculate(j))
    assert 0.2 < float(got["map"]) < 0.9  # the epoch really matches
    np.testing.assert_array_equal(got["classes"].numpy(), np.arange(6, dtype=np.int32))


@pytest.mark.parametrize("class_metrics", [False, True])
def test_grids_and_class_metrics(class_metrics):
    preds, target = coco_like(2)
    kwargs = {"class_metrics": class_metrics, "iou_thresholds": [0.3, 0.5, 0.75],
              "max_detection_thresholds": [1, 2, 5]}
    j, t = _pair(kwargs, preds, target)
    got = t.compute()
    _assert_equal(got, _np_out(j._compute_native_bbox()))
    _assert_equal(got, _jax_calculate(j))
    assert ("mar_5_per_class" in got) and got["map_per_class"].ndim == (1 if class_metrics else 0)


@pytest.mark.parametrize(
    "rec_thresholds", [[0.0, 0.2, 0.5, 0.7, 1.0], [1.0, 0.6, 0.3, 0.0], np.linspace(0, 1, 11)[::-1].tolist()]
)
def test_custom_and_non_ascending_rec_thresholds(rec_thresholds):
    preds, target = coco_like(3)
    j, t = _pair({"rec_thresholds": rec_thresholds, "class_metrics": True}, preds, target)
    got = t.compute()
    _assert_equal(got, _jax_calculate(j))
    if np.all(np.diff(rec_thresholds) >= 0):
        _assert_equal(got, _np_out(j._compute_native_bbox()))


def test_empty_gt_only_and_fp_only_epochs():
    empty = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}]
    no_gt = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}]
    j, t = _pair({}, empty * 3, no_gt * 3)
    got = t.compute()
    _assert_equal(got, _np_out(j._compute_native_bbox()))
    assert float(got["map"]) == -1.0 and got["classes"].numel() == 0
    preds, target = coco_like(4, n_images=6)
    fp_only = [dict(p) for p in preds]
    j, t = _pair({"class_metrics": True}, fp_only, no_gt * 6)  # detections, no ground truth
    _assert_equal(t.compute(), _np_out(j._compute_native_bbox()))
    j, t = _pair({"class_metrics": True}, empty * 6, target)  # ground truths, no detection
    got = t.compute()
    _assert_equal(got, _np_out(j._compute_native_bbox()))
    _assert_equal(got, _jax_calculate(j))


def test_mixed_label_dtypes_keep_large_class_ids():
    """An image with empty float labels beside int64 ids above 2**24: the one-read list
    state keeps each image's dtype, so no id rounds (a float32 ``torch.cat`` would merge
    2**24 + 1 into 2**24)."""
    preds, target = coco_like(5, n_images=8, n_classes=2)
    big = 2**24
    for d in (*preds, *target):
        d["labels"] = d["labels"] + big
    preds[0] = {"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.float32)}
    j, t = _pair({"class_metrics": True}, preds, target)
    got = t.compute()
    _assert_equal(got, _np_out(j._compute_native_bbox()))
    _assert_equal(got, _jax_calculate(j))
    np.testing.assert_array_equal(got["classes"].numpy(), np.array([big, big + 1], np.int32))


def _masks(boxes: np.ndarray, h: int = 48, w: int = 40) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    b = boxes / 10.0
    return ((xx >= b[:, None, None, 0]) & (xx < b[:, None, None, 2]) & (yy >= b[:, None, None, 1])
            & (yy < b[:, None, None, 3]))


@pytest.mark.parametrize("rle", [False, True])
def test_segm_dense_and_rle(rle):
    preds, target = coco_like(5, n_images=12, max_gt=4)
    jp, jt, tp, tt = [], [], [], []
    for p, g in zip(preds, target):
        pm, gm = _masks(p["boxes"]), _masks(g["boxes"])
        if rle:
            pm = [rle_mask._rle_encode_plain(m) for m in pm]
            gm = [rle_mask._rle_encode_plain(m) for m in gm]
        jp.append({"masks": pm, "scores": p["scores"], "labels": p["labels"]})
        jt.append({"masks": gm, "labels": g["labels"]})
        tp.append({"masks": pm if rle else torch.from_numpy(pm), "scores": torch.from_numpy(p["scores"]),
                   "labels": torch.from_numpy(p["labels"])})
        tt.append({"masks": gm if rle else torch.from_numpy(gm), "labels": torch.from_numpy(g["labels"])})
    j = JMAP(iou_type="segm", class_metrics=True)
    j.update(jp, jt)
    t = TMAP(iou_type="segm", class_metrics=True, device="cpu")
    t.update(tp, tt)
    got = t.compute()
    _assert_equal(got, _jax_calculate(j))
    assert float(got["map"]) > 0.1


# ------------------------------------------------------------------ packed-dict route


def test_packed_dict_route_and_mixed_epoch():
    preds, target = coco_like(6, n_images=24)
    batches = [pack(preds[i : i + 8], target[i : i + 8]) for i in range(0, 24, 8)]
    j, t = _pair({"class_metrics": True}, [], [], packed=batches)
    got = t.compute()
    _assert_equal(got, _np_out(j._compute_native_bbox()))
    _assert_equal(got, _jax_calculate(j))
    # a list update and packed updates in one epoch, and the cxcywh packed conversion
    more, more_t = coco_like(7, n_images=5)
    j, t = _pair({"box_format": "xyxy"}, more, more_t, packed=batches[:2])
    _assert_equal(t.compute(), _np_out(j._compute_native_bbox()))
    p, g = batches[0]
    cx = ({**p, "boxes": np.stack([_to_format(b, "cxcywh") for b in p["boxes"]])},
          {**g, "boxes": np.stack([_to_format(b, "cxcywh") for b in g["boxes"]])})
    j, t = _pair({"box_format": "cxcywh"}, [], [], packed=[cx])
    _assert_equal(t.compute(), _np_out(j._compute_native_bbox()))


def test_packed_dict_validation_errors():
    preds, target = coco_like(8, n_images=4)
    p, g = pack(preds, target)
    tp = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    with pytest.raises(ValueError, match="missing keys"):
        TMAP(device="cpu").update({"boxes": p["boxes"]}, g)
    with pytest.raises(ValueError, match="iou_type='bbox' only"):
        TMAP(iou_type="segm", device="cpu").update(p, g)
    with pytest.raises(ValueError, match=r"must be \(B, M, 4\)"):
        TMAP(device="cpu").update({**p, "boxes": p["boxes"][..., :3]}, g)
    with pytest.raises(ValueError, match="share the batch"):
        TMAP(device="cpu").update(p, {k: v[:2] for k, v in g.items()})
    big = p["labels"].copy()
    big[int(np.argmax(p["num_boxes"])), 0] = 2**24  # a valid slot
    with pytest.raises(ValueError, match="2\\*\\*24"):  # host labels: at update
        TMAP(device="cpu").update({**p, "labels": big}, g)
    m = TMAP(device="cpu")  # device labels: at compute, on the buffers it reads
    m.update(tp({**p, "labels": big}), tp(g))
    with pytest.raises(ValueError, match="2\\*\\*24"):
        m.compute()
    m = TMAP(device="cpu")
    m.update(tp({**p, "num_boxes": p["num_boxes"] + 20}), tp(g))
    with pytest.raises(ValueError, match="out of range"):
        m.compute()


def test_compute_reads_each_list_state_once(monkeypatch):
    """Nine list states, nine reads, however many images: one ``.cpu()`` per state."""
    preds, target = coco_like(9, n_images=30)
    t = TMAP(device="cpu")
    t.update(_torch(preds), _torch(target))
    p, g = pack(preds[:8], target[:8])
    for _ in range(3):
        t.update({k: torch.from_numpy(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in g.items()})
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(tuple(self.shape)) or real_cpu(self, *a, **k))
    before = tmean_ap._STATS.map_host_evals
    t.compute()
    assert len(calls) == 9, calls
    assert tmean_ap._STATS.map_host_evals == before + 1


# ------------------------------------------------------------------ in-graph route


def _packed_batch(rng, b, m, g, c, fmt="xyxy"):
    preds, target = coco_like(int(rng.randint(1 << 30)), n_images=b, n_classes=c, max_gt=g, max_fp=max(m - g, 0))
    p, t = pack(preds, target, width=m, gt_width=g)
    p["scores"] = np.round(p["scores"] * 256) / 256  # a score grid the histograms resolve
    return p, t


@pytest.mark.parametrize("shape", [(4, 16, 8), (3, 8, 4)])
def test_packed_contributions_equal_jax(shape):
    b, m, g = shape
    rng = np.random.RandomState(b)
    jm = jingraph.PackedMeanAveragePrecision(num_classes=6, score_bins=64, class_metrics=True)
    tm_ = PackedMeanAveragePrecision(num_classes=6, score_bins=64, class_metrics=True, device="cpu")
    for _ in range(2):
        p, t = _packed_batch(rng, b, m, g, 6)
        jarrs = jingraph.pack_detections(p, t)
        tarrs = tingraph.pack_detections(p, t)
        for ja, ta in zip(jarrs, tarrs):
            np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        want = jingraph.packed_contributions(*jarrs, jm._params)
        got = tingraph.packed_contributions(*tarrs, tm_._params)
        for w, x in zip(want, got):
            assert x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), np.asarray(w))
        jm.update(*jarrs)
        tm_.update(*tarrs)
    want = {k: np.asarray(v) for k, v in jingraph.compute_from_hists(
        jm.map_tp_hist, jm.map_fp_hist, jm.map_n_pos, jm._params).items()}
    got = tm_.compute()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])


def test_ragged_widths_pack_and_engine_replays_bit_equal():
    rng = np.random.RandomState(11)
    batches = [_packed_batch(rng, b, m, g, 5) for b, m, g in ((4, 5, 3), (3, 7, 6), (4, 8, 5), (2, 6, 2))]
    packed = [tingraph.pack_detections(p, t) for p, t in batches]
    assert {(pp.shape[1], tt.shape[1]) for pp, _, tt, _ in packed} == {(8, 8)}  # min bucket 8
    for (pp, pc, tt, tc), (p, _) in zip(packed, batches):
        m = p["boxes"].shape[1]
        assert (pp[:, m:, 5] == -1).all() and (pc <= m).all()
    eager = PackedMeanAveragePrecision(num_classes=5, score_bins=256, device="cpu", compiled_update=False)
    with engine_context(True):
        eng = PackedMeanAveragePrecision(num_classes=5, score_bins=256, device="cpu")
        for arrs in packed:
            eng.update(*arrs)
            eager.update(*arrs)
        st = eng._engine.stats
        assert st.dispatches == len(packed) and st.eager_fallbacks == 0, st.as_dict()
        assert st.bucketed_steps == len(packed)  # batch sizes 4, 3, 4, 2 share bucket 8
        for attr in ("map_tp_hist", "map_fp_hist", "map_n_pos"):
            assert torch.equal(getattr(eng, attr), getattr(eager, attr)), attr
        got = eng.compute()
        assert eng._epoch.stats.compute_dispatches == 1 and eng._epoch.stats.eager_fallbacks == 0
    want = eager.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the packed route against the host route over the same images (within the bins)
    host = TMAP(device="cpu")
    for p, t in batches:
        host.update({k: torch.from_numpy(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in t.items()})
    h = host.compute()
    for k in ("map", "map_50", "mar_100"):
        assert abs(float(h[k]) - float(want[k])) < 1e-6, k


def test_ingraph_validation():
    with pytest.raises(ValueError, match="num_classes"):
        PackedMeanAveragePrecision(num_classes=0, device="cpu")
    with pytest.raises(ValueError, match="score_bins"):
        PackedMeanAveragePrecision(num_classes=2, score_bins=1, device="cpu")
    p, t = _packed_batch(np.random.RandomState(0), 5, 6, 4, 3)
    assert p["num_boxes"].sum() > 0
    with pytest.raises(ValueError, match=r"scores must lie in \[0, 1\]"):
        tingraph.pack_detections({**p, "scores": p["scores"] + 5.0}, t)
    with pytest.raises(ValueError, match="num_boxes out of range"):
        tingraph.pack_detections({**p, "num_boxes": p["num_boxes"] + 7}, t)
    with pytest.raises(ValueError, match="missing keys"):
        tingraph.pack_detections({"boxes": p["boxes"]}, t)


# ------------------------------------------------------------------ sync over two ranks

_SYNC_BODY = _DATA + '''
import torch
from torchmetrics_tpu_torch.detection import MeanAveragePrecision, PackedMeanAveragePrecision
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


def rank_batches(rank):
    preds, target = coco_like(20 + rank, n_images=16)
    return [pack(preds[i : i + 4], target[i : i + 4]) for i in range(0, 16, 4)]


def as_torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def run(rank):
    listed = lambda out: {k: v.tolist() for k, v in out.items()}
    packed_dict = MeanAveragePrecision(class_metrics=True, device="cpu")
    packed = PackedMeanAveragePrecision(num_classes=6, score_bins=128, device="cpu")
    for p, t in rank_batches(rank):
        packed_dict.update(as_torch(p), as_torch(t))
        packed.update_batch(p, t)
    out = {"packed_dict": listed(packed_dict.compute()), "packed": listed(packed.compute())}
    preds, target = coco_like(30 + rank, n_images=3 + rank)  # ragged per-image lists
    ragged = MeanAveragePrecision(device="cpu")
    ragged.update([{k: torch.from_numpy(v) for k, v in d.items()} for d in preds],
                  [{k: torch.from_numpy(v) for k, v in d.items()} for d in target])
    try:
        ragged.compute()
        out["ragged"] = None
    except TorchMetricsUserError as err:
        out["ragged"] = str(err)
    return out
'''


def test_two_rank_sync_equals_one_process(tmp_path):
    ranks = run_two_ranks(tmp_path, _SYNC_BODY)
    ns: dict = {}
    exec(_SYNC_BODY, ns)
    # the packed sync interleaves list elements by position: rank 0's batch 0, rank 1's ...
    order = [b for pair in zip(ns["rank_batches"](0), ns["rank_batches"](1)) for b in pair]
    one = TMAP(class_metrics=True, device="cpu")
    one_packed = PackedMeanAveragePrecision(num_classes=6, score_bins=128, device="cpu")
    for p, t in order:
        one.update(ns["as_torch"](p), ns["as_torch"](t))
        one_packed.update_batch(p, t)
    want = {k: v.tolist() for k, v in one.compute().items()}
    want_packed = {k: v.tolist() for k, v in one_packed.compute().items()}
    for res in ranks:
        assert res["ok"], res
        assert res["packed_dict"] == want
        assert res["packed"] == want_packed
        assert res["ragged"] is not None and "differing element counts" in res["ragged"], res["ragged"]
