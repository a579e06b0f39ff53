"""Multilabel classification: the port (on the CPU) against the JAX package.

Every multilabel class of the slice (stat scores, accuracy, precision, recall, F-beta,
F1, confusion matrix, PR curve, ROC, AUROC, average precision) and its functional
twin take the same seeded numpy batches as the JAX package, at the three protocol
levels (``torch_parity.three_levels``), with ``average`` in micro / macro / weighted /
none, thresholds None / int / list / tensor, ``ignore_index`` (whose sentinel
``-4 * L * T``, or ``-4 * L`` in exact mode, lands in the exact-mode state and must
match), ``multidim_average``, logits against probabilities and NaN scores.

Tolerances: counts and every other integer state exact; ratios 1e-6 (relative 1e-6
too for float32 means of counts); AUROC, AP and curve points 1e-5; exact-mode score
lists (sigmoid outputs) ``SIGMOID_ATOL``. Kernel K2's plain version is held against the
JAX package's ``_binned_multi_threshold_confmat`` with a per-element ``(N, L)`` mask,
integer-exact.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.classification as tf
from tests.torch_parity import SIGMOID_ATOL, assert_close, assert_states, jax_scores, three_levels
from torchmetrics_tpu.functional.classification.precision_recall_curve import (
    _binned_multi_threshold_confmat as jax_binned_confmat,
)
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _binned_multi_threshold_confmat
from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds

N_BATCHES, BATCH, L = 4, 48, 5
RATIO_ATOL, CURVE_ATOL = 1e-6, 1e-5
AVERAGES = ["micro", "macro", "weighted", "none"]
STAT_CLASSES = ["MultilabelStatScores", "MultilabelAccuracy", "MultilabelPrecision", "MultilabelRecall", "MultilabelF1Score"]


def _batches(seed: int, kind: str = "logits", ignore_index=None, extra: int = 0, thresholds=None):
    """``(port preds, target, JAX preds)`` of shape ``(N, L[, extra])``; ``kind``: logits,
    probs, labels or nan."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, L, extra) if extra else (BATCH, L)
    out = []
    for _ in range(N_BATCHES):
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        if kind == "labels":
            preds = rng.integers(0, 2, shape)
        elif kind == "probs":
            preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
        else:
            preds = logits
            if kind == "nan":
                preds[rng.random(shape) < 0.05] = np.nan
        target = (rng.random(shape) < 0.3).astype(np.int64)
        if ignore_index is not None:
            target[rng.random(shape) < 0.1] = ignore_index
        out.append((preds, target, jax_scores(preds, thresholds)))
    return out


def _pair(name: str, **kwargs):
    return (
        lambda: getattr(tc, name)(num_labels=L, **kwargs, device="cpu"),
        lambda: getattr(jc, name)(num_labels=L, **kwargs),
    )


# ------------------------------------------------------------------ stat-scores family


@pytest.mark.parametrize("name", STAT_CLASSES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize(("kind", "ignore_index"), [("logits", -1), ("probs", None), ("labels", -1)])
def test_stat_scores_family_global(name, average, kind, ignore_index):
    make_port, make_ref = _pair(name, average=average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(3, kind, ignore_index), RATIO_ATOL, rtol=1e-6)


@pytest.mark.parametrize("name", STAT_CLASSES)
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_stat_scores_family_samplewise(name, average):
    make_port, make_ref = _pair(name, average=average, multidim_average="samplewise", ignore_index=-1)
    three_levels(make_port, make_ref, _batches(5, "logits", -1, extra=3), RATIO_ATOL, rtol=1e-6)


@pytest.mark.parametrize("average", AVERAGES)
def test_fbeta(average):
    make_port, make_ref = _pair("MultilabelFBetaScore", beta=2.0, average=average, threshold=0.35, ignore_index=-1)
    three_levels(make_port, make_ref, _batches(7, "probs", -1), RATIO_ATOL, rtol=1e-6)


def test_nan_scores_count_as_negative():
    make_port, make_ref = _pair("MultilabelStatScores", average="none")
    batches = _batches(9, "nan")
    assert any(np.isnan(p).any() for p, _, _ in batches)
    three_levels(make_port, make_ref, batches, RATIO_ATOL)


@pytest.mark.parametrize(
    ("port_fn", "ref_fn", "kwargs"),
    [
        (tf.multilabel_stat_scores, jf.multilabel_stat_scores, dict(average="none", ignore_index=-1)),
        (tf.multilabel_accuracy, jf.multilabel_accuracy, dict(average="micro")),
        (tf.multilabel_precision, jf.multilabel_precision, dict(average="weighted", ignore_index=-1)),
        (tf.multilabel_recall, jf.multilabel_recall, dict(average="macro")),
        (tf.multilabel_fbeta_score, jf.multilabel_fbeta_score, dict(beta=0.5, average="macro", ignore_index=-1)),
        (tf.multilabel_f1_score, jf.multilabel_f1_score, dict(average="micro", ignore_index=-1)),
        (tf.multilabel_confusion_matrix, jf.multilabel_confusion_matrix, dict(normalize="pred", ignore_index=-1)),
    ],
)
def test_functional_stat_scores_family(port_fn, ref_fn, kwargs):
    for preds, target, jpreds in _batches(11, "logits", kwargs.get("ignore_index")):
        assert_close(
            port_fn(torch.from_numpy(preds), torch.from_numpy(target), num_labels=L, **kwargs),
            ref_fn(jnp.asarray(jpreds), jnp.asarray(target), num_labels=L, **kwargs),
            RATIO_ATOL, rtol=1e-6,
        )


# ------------------------------------------------------------------ confusion matrix


@pytest.mark.parametrize("normalize", [None, "true", "all"])
@pytest.mark.parametrize(("kind", "ignore_index", "extra"), [("logits", -1, 0), ("labels", None, 3), ("probs", -1, 3)])
def test_confusion_matrix(normalize, kind, ignore_index, extra):
    make_port, make_ref = _pair("MultilabelConfusionMatrix", normalize=normalize, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(13, kind, ignore_index, extra), RATIO_ATOL)


# ------------------------------------------------------------------ curve family

THRESHOLDS = [None, 11, [0.0, 0.25, 0.5, 0.5, 1.0], "tensor"]


def _curve_pair(name: str, thresholds, **kwargs):
    thr = torch.linspace(0.1, 0.9, 7) if thresholds == "tensor" else thresholds
    jthr = jnp.asarray(thr.numpy()) if isinstance(thr, torch.Tensor) else thr
    np_thr = thr.numpy() if isinstance(thr, torch.Tensor) else thr
    return (
        lambda: getattr(tc, name)(num_labels=L, thresholds=thr, **kwargs, device="cpu"),
        lambda: getattr(jc, name)(num_labels=L, thresholds=jthr, **kwargs),
        np_thr,
    )


@pytest.mark.parametrize("name", ["MultilabelPrecisionRecallCurve", "MultilabelROC"])
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=["exact", "int", "list", "tensor"])
@pytest.mark.parametrize(("kind", "ignore_index"), [("logits", -1), ("probs", None)])
def test_curves(name, thresholds, kind, ignore_index):
    make_port, make_ref, thr = _curve_pair(name, thresholds, ignore_index=ignore_index)
    batches = _batches(17, kind, ignore_index, thresholds=thr)
    three_levels(make_port, make_ref, batches, CURVE_ATOL, float_state_atol=SIGMOID_ATOL)


@pytest.mark.parametrize("name", ["MultilabelAUROC", "MultilabelAveragePrecision"])
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=["exact", "int", "list", "tensor"])
def test_auroc_and_average_precision(name, average, thresholds):
    make_port, make_ref, thr = _curve_pair(name, thresholds, average=average, ignore_index=-1)
    batches = _batches(19, "logits", -1, thresholds=thr)
    three_levels(make_port, make_ref, batches, CURVE_ATOL, float_state_atol=SIGMOID_ATOL)


@pytest.mark.parametrize("thresholds", [None, 11])
def test_ignore_sentinel_lands_in_the_state(thresholds):
    """Ignored elements hold ``-4 * L * T`` (binned) or ``-4 * L`` (exact) in both the
    scores and the targets, as in the JAX package; the binned tensor counts none."""
    make_port, make_ref, thr = _curve_pair("MultilabelAveragePrecision", thresholds, ignore_index=-1)
    port, ref = make_port(), make_ref()
    preds, target, jpreds = _batches(21, "probs", -1, thresholds=thr)[0]
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(jpreds), jnp.asarray(target))
    assert_states(port, ref)
    if thresholds is None:
        sentinel = -4 * L
        assert int((port.target[0] == sentinel).sum()) == int((target == -1).sum())
        assert torch.equal(port.preds[0][port.target[0] == sentinel], torch.full(((target == -1).sum(),), float(sentinel)))
    else:
        assert int(port.confmat[0].sum()) == int((target != -1).sum())


@pytest.mark.parametrize("name", ["MultilabelAUROC", "MultilabelAveragePrecision"])
@pytest.mark.parametrize("thresholds", [None, 11])
def test_curve_family_nan_scores(name, thresholds):
    make_port, make_ref, thr = _curve_pair(name, thresholds)
    port, ref = make_port(), make_ref()
    for preds, target, jpreds in _batches(23, "nan", thresholds=thr):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
    if thresholds is not None:
        assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), CURVE_ATOL)


@pytest.mark.parametrize(
    ("port_fn", "ref_fn", "kwargs"),
    [
        (tf.multilabel_precision_recall_curve, jf.multilabel_precision_recall_curve, dict(thresholds=9, ignore_index=-1)),
        (tf.multilabel_roc, jf.multilabel_roc, dict(thresholds=None, ignore_index=-1)),
        (tf.multilabel_auroc, jf.multilabel_auroc, dict(average="micro", thresholds=None, ignore_index=-1)),
        (tf.multilabel_auroc, jf.multilabel_auroc, dict(average="weighted", thresholds=15)),
        (tf.multilabel_average_precision, jf.multilabel_average_precision, dict(average="macro", thresholds=None)),
        (tf.multilabel_average_precision, jf.multilabel_average_precision, dict(average="micro", thresholds=15, ignore_index=-1)),
    ],
)
def test_functional_curve_family(port_fn, ref_fn, kwargs):
    for preds, target, jpreds in _batches(25, "logits", kwargs.get("ignore_index"), thresholds=kwargs["thresholds"])[:2]:
        assert_close(
            port_fn(torch.from_numpy(preds), torch.from_numpy(target), num_labels=L, **kwargs),
            ref_fn(jnp.asarray(jpreds), jnp.asarray(target), num_labels=L, **kwargs),
            CURVE_ATOL,
        )


# ------------------------------------------------------------------ K2 with a per-element mask


@pytest.mark.parametrize("kind", ["random", "on_threshold"])
@pytest.mark.parametrize(("n", "labels", "t"), [(1031, 80, 200), (257, 3, 7)])
def test_k2_plain_with_per_element_mask_matches_jax(kind, n, labels, t):
    """The binned multilabel update's K2 call, ``(N, L)`` scores with the sentinel on
    ignored elements and an ``(N, L)`` bool mask, against the JAX package's
    ``_binned_multi_threshold_confmat``."""
    rng = np.random.default_rng(n + labels)
    with jax.enable_x64(False):
        thr = np.asarray(jnp.linspace(0, 1, t))
    preds = rng.uniform(0, 1, (n, labels)).astype(np.float32)
    if kind == "on_threshold":
        preds = thr[rng.integers(0, t, (n, labels))]
    preds[rng.random((n, labels)) < 0.01] = np.nan
    target = (rng.random((n, labels)) < 0.2).astype(np.int64)
    ignored = rng.random((n, labels)) < 0.05
    target[ignored] = -4 * labels * t
    preds[ignored] = -4 * labels * t
    p, tg = torch.from_numpy(preds), torch.from_numpy(target)
    got = _binned_multi_threshold_confmat(p, tg > 0, tg >= 0, sort_thresholds(torch.from_numpy(thr)))
    want = jax_binned_confmat(jnp.asarray(preds), jnp.asarray(target > 0), jnp.asarray(target >= 0), jnp.asarray(thr))
    assert got.shape == (t, labels, 2, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0].sum()) == int((~ignored).sum())


def test_multilabel_updates_without_validation_read_nothing_back(monkeypatch):
    """With ``validate_args=False`` the stat-scores and confusion-matrix updates never
    turn a device tensor into a Python value."""
    metrics = [
        tc.MultilabelF1Score(L, ignore_index=-1, validate_args=False, device="cpu"),
        tc.MultilabelConfusionMatrix(L, ignore_index=-1, validate_args=False, device="cpu"),
    ]
    preds, target, _ = _batches(27, "logits", -1)[0]
    preds, target = torch.from_numpy(preds), torch.from_numpy(target)

    def forbidden(self, *args, **kwargs):
        raise AssertionError("a device tensor was read back in an update that must not sync")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, forbidden)
    for metric in metrics:
        metric.update(preds, target)


# ------------------------------------------------------------------ collection


def _collection_members(port: bool, thresholds: int = 20) -> dict:
    """The multilabel path's collection (``chip_smoke.py``) at a small size."""
    mod, extra = (tc, dict(device="cpu")) if port else (jc, {})
    common = dict(num_labels=L, ignore_index=-1, **extra)
    return {
        "map": mod.MultilabelAveragePrecision(thresholds=thresholds, **common),
        "auroc": mod.MultilabelAUROC(thresholds=thresholds, **common),
        "f1_macro": mod.MultilabelF1Score(average="macro", **common),
        "f1_micro": mod.MultilabelF1Score(average="micro", **common),
        "acc": mod.MultilabelAccuracy(**common),
        "cm": mod.MultilabelConfusionMatrix(**common),
    }


def test_collection_groups_states_and_values_match_jax(monkeypatch):
    """The port settles its groups when built (every member declares a signature), on
    the groups the JAX package reaches after its first update; K2 runs once per update."""
    from torchmetrics_tpu import MetricCollection as JaxMetricCollection

    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    calls = []
    real = prc.multi_threshold_confmat
    monkeypatch.setattr(prc, "multi_threshold_confmat", lambda *a: calls.append(1) or real(*a))
    port = MetricCollection(_collection_members(True))
    ref = JaxMetricCollection(_collection_members(False))
    assert port._groups_checked
    expected = {frozenset({"map", "auroc"}), frozenset({"f1_macro", "f1_micro", "acc"}), frozenset({"cm"})}
    assert {frozenset(g) for g in port.compute_groups.values()} == expected
    for i, (preds, target, jpreds) in enumerate(_batches(29, "logits", -1, thresholds=20)):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
        assert len(calls) == i + 1
    assert {frozenset(g) for g in ref.compute_groups.values()} == expected
    for name, metric in port.items(keep_base=True):
        assert_states(metric, ref[name])
    want = ref.compute()
    for key, value in port.compute().items():
        assert_close(value, want[key], CURVE_ATOL, rtol=1e-6, msg=key)


def test_different_thresholds_do_not_fuse():
    """The binned curve's signature holds the threshold values: equal counts of other
    thresholds, or another ``ignore_index``, keep separate groups."""
    members = {
        "a": tc.MultilabelAUROC(L, thresholds=11, device="cpu"),
        "b": tc.MultilabelAUROC(L, thresholds=torch.linspace(0.05, 0.95, 11), device="cpu"),
        "c": tc.MultilabelAUROC(L, thresholds=11, ignore_index=-1, device="cpu"),
        "d": tc.MultilabelAveragePrecision(L, thresholds=11, device="cpu"),
    }
    assert sorted(sorted(g) for g in MetricCollection(members).compute_groups.values()) == [["a", "d"], ["b"], ["c"]]
