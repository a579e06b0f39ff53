"""The port's box overlaps, panoptic qualities and host C++ kernels against the JAX
package and their plain versions, on the CPU.

- The IoU family (IoU, GIoU, DIoU, CIoU), functional and modular, within 1e-6 of the JAX
  package: matrices, thresholds, aggregates, box formats, class metrics, ``respect_labels``
  and images without boxes; ``compute`` reads each list state once.
- The panoptic qualities, functional and modular: values within 1e-6, the integer counts
  exactly equal to the JAX package's.
- The native copy (``torchmetrics_tpu_torch/native``): ``coco_match``, ``rle_*`` and
  ``lcs_len`` against their numpy versions; a build with a bad compiler raises with the
  compiler's message instead of taking numpy; ROUGE-L's ``_lcs`` goes through ``lcs_len``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu.detection as jdet
import torchmetrics_tpu.functional.detection as jF
import torchmetrics_tpu_torch.detection as tdet
import torchmetrics_tpu_torch.functional.detection as tF
from torchmetrics_tpu_torch.functional.text import rouge as trouge
from torchmetrics_tpu_torch.native import rle_mask

ATOL = 1e-6
VARIANTS = ("intersection_over_union", "generalized_intersection_over_union",
            "distance_intersection_over_union", "complete_intersection_over_union")
CLASSES = ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion",
           "DistanceIntersectionOverUnion", "CompleteIntersectionOverUnion")


def _boxes(rng, n, spread=300.0):
    xy = rng.rand(n, 2) * spread
    return np.concatenate([xy, xy + rng.rand(n, 2) * 120 + 2], 1).astype(np.float32)


def _images(seed, n_images=8, n_classes=3):
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n_images):
        g = 0 if i == 3 else rng.randint(1, 5)
        gt = _boxes(rng, g)
        det = (gt + rng.randn(g, 4).astype(np.float32) * 6).astype(np.float32)
        gl = rng.randint(0, n_classes, g)
        dl = np.where(rng.rand(g) < 0.8, gl, rng.randint(0, n_classes, g))
        preds.append({"boxes": det, "scores": rng.rand(g).astype(np.float32), "labels": dl})
        target.append({"boxes": gt, "labels": gl})
    return preds, target


def _torch(items):
    return [{k: torch.from_numpy(v) for k, v in d.items()} for d in items]


# ------------------------------------------------------------------ IoU family


@pytest.mark.parametrize("name", VARIANTS)
def test_functional_variants_match_jax(name):
    rng = np.random.RandomState(0)
    p, t = _boxes(rng, 7), _boxes(rng, 5)
    p[0] = t[0]  # an identical pair
    for kwargs in ({"aggregate": False}, {}, {"iou_threshold": 0.3, "replacement_val": -1.0, "aggregate": False}):
        want = np.asarray(getattr(jF, name)(p, t, **kwargs))
        got = getattr(tF, name)(torch.from_numpy(p), torch.from_numpy(t), **kwargs)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("box_format", ["xyxy", "cxcywh"])
@pytest.mark.parametrize("name", CLASSES)
def test_modular_variants_match_jax(name, box_format):
    preds, target = _images(1)
    kwargs = {"box_format": box_format, "class_metrics": True}
    jm, tm_ = getattr(jdet, name)(**kwargs), getattr(tdet, name)(device="cpu", **kwargs)
    jm.update(preds[:4], target[:4])
    tm_.update(_torch(preds[:4]), _torch(target[:4]))
    jm.update(preds[4:], target[4:])
    tm_.update(_torch(preds[4:]), _torch(target[4:]))
    want = {k: np.asarray(v) for k, v in jm.compute().items()}
    got = tm_.compute()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("respect_labels", [False, True])
def test_modular_threshold_labels_and_empty(respect_labels):
    preds, target = _images(2)
    kwargs = {"iou_threshold": 0.5, "respect_labels": respect_labels}
    jm, tm_ = jdet.IntersectionOverUnion(**kwargs), tdet.IntersectionOverUnion(device="cpu", **kwargs)
    jm.update(preds, target)
    tm_.update(_torch(preds), _torch(target))
    np.testing.assert_allclose(tm_.compute()["iou"].numpy(), np.asarray(jm.compute()["iou"]), atol=ATOL)
    empty = tdet.IntersectionOverUnion(device="cpu")
    empty.update([{"boxes": torch.zeros(0), "scores": torch.zeros(0), "labels": torch.zeros(0, dtype=torch.long)}],
                 [{"boxes": torch.zeros(0), "labels": torch.zeros(0, dtype=torch.long)}])
    assert float(empty.compute()["iou"]) == 0.0


def test_iou_compute_reads_each_list_state_once(monkeypatch):
    preds, target = _images(3, n_images=20)
    m = tdet.IntersectionOverUnion(device="cpu", class_metrics=True)
    m.update(_torch(preds), _torch(target))
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(1) or real_cpu(self, *a, **k))
    m.compute()
    assert len(calls) == 3


def test_input_validation_matches_jax():
    good_p = [{"boxes": torch.zeros(1, 4), "scores": torch.zeros(1), "labels": torch.zeros(1, dtype=torch.long)}]
    good_t = [{"boxes": torch.zeros(1, 4), "labels": torch.zeros(1, dtype=torch.long)}]
    cases = [
        (good_p, good_t * 2, "same length"),
        ([{"boxes": torch.zeros(1, 4), "labels": torch.zeros(1)}], good_t, "`scores` key"),
        ([{**good_p[0], "boxes": [[0, 0, 1, 1]]}], good_t, "boxes in `preds` to be of type Array"),
        (good_p, [{"boxes": torch.zeros(2, 4), "labels": torch.zeros(1)}], "different length"),
    ]
    for p, t, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tdet.IntersectionOverUnion(device="cpu").update(p, t)
        jp = [{k: v if isinstance(v, list) else v.numpy() for k, v in d.items()} for d in p]
        jt = [{k: v.numpy() for k, v in d.items()} for d in t]
        with pytest.raises(ValueError, match=msg):
            jdet.IntersectionOverUnion().update(jp, jt)


# ------------------------------------------------------------------ panoptic qualities

THINGS, STUFFS = {0, 1, 2}, {6, 7}


def _panoptic_maps(seed, b=2, h=24, w=32):
    """(B, H, W, 2) maps of (category, instance): stuff regions and thing instances, with
    the prediction a perturbed copy of the target and an unknown category in places."""
    rng = np.random.RandomState(seed)
    target = np.zeros((b, h, w, 2), np.int64)
    target[..., 0] = rng.choice([6, 7], (b, 1, 1))
    for i in range(b):
        for inst in range(1, 5):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            target[i, y : y + rng.randint(3, 9), x : x + rng.randint(3, 9)] = (rng.randint(0, 3), inst)
    preds = target.copy()
    noise = rng.rand(b, h, w) < 0.15
    preds[noise] = np.stack([rng.choice([0, 1, 2, 6, 7], noise.sum()), rng.randint(0, 5, noise.sum())], -1)
    preds[:, :2, :2] = (9, 0)  # not a known category
    return preds, target


@pytest.mark.parametrize("modified", [False, True])
def test_panoptic_functional_and_modular_match_jax(modified):
    fname = "modified_panoptic_quality" if modified else "panoptic_quality"
    cname = "ModifiedPanopticQuality" if modified else "PanopticQuality"
    batches = [_panoptic_maps(s) for s in range(3)]
    p, t = batches[0]
    want = float(np.asarray(getattr(jF, fname)(p, t, THINGS, STUFFS, allow_unknown_preds_category=True)))
    got = getattr(tF, fname)(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS, allow_unknown_preds_category=True)
    assert got.dtype == torch.float32 and abs(float(got) - want) < ATOL
    jm = getattr(jdet, cname)(THINGS, STUFFS, allow_unknown_preds_category=True)
    tm_ = getattr(tdet, cname)(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu")
    for p, t in batches:
        jm.update(p, t)
        tm_.update(torch.from_numpy(p), torch.from_numpy(t))
    for attr in ("true_positives", "false_positives", "false_negatives"):
        np.testing.assert_array_equal(getattr(tm_, attr).numpy(), np.asarray(getattr(jm, attr)), err_msg=attr)
    np.testing.assert_allclose(tm_.iou_sum.numpy(), np.asarray(jm.iou_sum), atol=ATOL, rtol=0)
    assert abs(float(tm_.compute()) - float(np.asarray(jm.compute()))) < ATOL
    with pytest.raises(ValueError, match="Unknown categories"):
        getattr(tF, fname)(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS)


def test_panoptic_update_reads_the_maps_once(monkeypatch):
    p, t = _panoptic_maps(5)
    m = tdet.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu")
    calls = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(1) or real_cpu(self, *a, **k))
    m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert len(calls) == 1


def test_panoptic_validation_and_root_alias():
    with pytest.raises(ValueError, match="distinct keys"):
        tdet.PanopticQuality({0, 1}, {1, 2}, device="cpu")
    with pytest.raises(TypeError, match="to be an array"):
        tF.panoptic_quality([[0, 0]], torch.zeros(1, 2, 2), THINGS, STUFFS)
    with pytest.raises(ValueError, match="exactly 2 channels"):
        tF.panoptic_quality(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3), THINGS, STUFFS)
    import torchmetrics_tpu_torch as ttm

    with pytest.warns(DeprecationWarning, match="torchmetrics_tpu_torch.detection.PanopticQuality"):
        ttm.PanopticQuality(THINGS, STUFFS, device="cpu")


# ------------------------------------------------------------------ native copy


def test_rle_kernels_match_plain_versions():
    rng = np.random.RandomState(0)
    masks = [rng.rand(13, 9) < q for q in (0.0, 0.1, 0.5, 0.9, 1.0)]
    masks.append(np.zeros((0, 4), bool))
    for m in masks:
        enc, plain = rle_mask.rle_encode(m), rle_mask._rle_encode_plain(m)
        assert enc["size"] == plain["size"]
        np.testing.assert_array_equal(enc["counts"], plain["counts"])
        np.testing.assert_array_equal(rle_mask.rle_decode(enc), m)
        np.testing.assert_array_equal(rle_mask._rle_decode_plain(enc), m)
        assert rle_mask.rle_area(enc) == rle_mask._rle_area_plain(enc) == int(m.sum())
    dets = [rle_mask.rle_encode(m) for m in masks[:5]]
    gts = [rle_mask.rle_encode(rng.rand(13, 9) < 0.4) for _ in range(3)]
    crowd = [False, True, False]
    np.testing.assert_array_equal(rle_mask.rle_iou(dets, gts, crowd), rle_mask._rle_iou_plain(dets, gts, crowd))
    np.testing.assert_array_equal(rle_mask.rle_iou(dets, gts), rle_mask._rle_iou_plain(dets, gts))


@pytest.mark.parametrize("seed", range(4))
def test_coco_match_matches_plain_version(seed):
    rng = np.random.RandomState(seed)
    d, g = rng.randint(0, 9), rng.randint(0, 7)
    iou = np.round(rng.rand(d, g), 1)  # ties and on-threshold values
    args = (iou, rng.rand(d) * 1e4, rng.rand(g) * 1e4, np.array([0.3, 0.5, 0.7]),
            np.array([[0, 1e10], [0, 1024], [1024, 9216], [9216, 1e10]]))
    for got, want in zip(rle_mask.coco_match(*args), rle_mask._coco_match_plain(*args)):
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)


def test_lcs_len_matches_plain_version_and_rouge_uses_it(monkeypatch):
    rng = np.random.RandomState(0)
    for n, m in ((0, 4), (5, 0), (7, 9), (30, 25)):
        a, b = rng.randint(0, 6, n), rng.randint(0, 6, m)
        assert rle_mask.lcs_len(a, b) == rle_mask._lcs_len_plain(a, b)
    calls = []
    real = rle_mask.lcs_len
    monkeypatch.setattr(rle_mask, "lcs_len", lambda a, b: calls.append((len(a), len(b))) or real(a, b))
    pred, tgt = "the cat sat on the mat".split(), "a cat sat on a mat today".split()
    assert trouge._lcs(pred, tgt) == int(trouge._lcs_table(pred, tgt)[-1, -1]) == 4
    assert calls == [(6, 7)]


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(rle_mask, "_LIB", None)
    monkeypatch.setattr(rle_mask, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(rle_mask, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not start"):
        rle_mask.rle_area({"size": [1, 1], "counts": [0, 1]})
    with pytest.raises(RuntimeError, match="could not start"):
        rle_mask.native_available()
    monkeypatch.setattr(rle_mask, "CXX", "g++")
    monkeypatch.setattr(rle_mask, "CXX_FLAGS", ("-O2", "-shared", "-fPIC", "-DTM_BROKEN", "-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match="no_such_header"):
        rle_mask.lcs_len(np.arange(3), np.arange(3))
    assert rle_mask._LIB is None and not list(tmp_path.glob("*.so"))  # nothing half-built is left


@pytest.mark.parametrize("module", ["iou", "giou", "diou", "ciou", "mean_ap", "ingraph", "panoptic_qualities"])
def test_docstring_examples(module):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(f"torchmetrics_tpu_torch.detection.{module}"),
                              optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0, results
