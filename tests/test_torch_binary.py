"""Binary classification: the port (on the CPU) against the JAX package.

Every binary class of the slice (stat scores, accuracy, precision, recall, F-beta,
F1, confusion matrix, PR curve, ROC, AUROC, average precision) and its functional
twin take the same seeded numpy batches as the JAX package, at the three protocol
levels (``torch_parity.three_levels``), with thresholds None / int / list / tensor,
``ignore_index``, ``multidim_average``, ``max_fpr``, logits against probabilities and
NaN scores.

Tolerances: counts and every other integer state exact; ratios (accuracy, precision,
recall, F-beta, normalized matrices) 1e-6; AUROC, AP and curve points 1e-5 (sums in
another order, and JAX's 64-bit mode computes the exact curve in float64); exact-mode
score lists (sigmoid outputs) ``SIGMOID_ATOL``. Kernel K2's plain version is held
against the JAX package's ``_binned_multi_threshold_confmat`` at ``C = 1``, integer-exact.
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

N_BATCHES, BATCH = 4, 96
RATIO_ATOL, CURVE_ATOL = 1e-6, 1e-5
STAT_CLASSES = ["BinaryStatScores", "BinaryAccuracy", "BinaryPrecision", "BinaryRecall", "BinaryF1Score"]


def _batches(seed: int, kind: str = "logits", ignore_index=None, extra: int = 0, thresholds=None):
    """``(port preds, target, JAX preds)``; ``kind``: logits, probs, labels, peaked or nan."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, extra) if extra else (BATCH,)
    out = []
    for _ in range(N_BATCHES):
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        if kind == "labels":
            preds = rng.integers(0, 2, shape)
        elif kind == "probs":
            preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
        elif kind == "peaked":  # a trained classifier: most scores near 0 or 1
            preds = (1 / (1 + np.exp(-8 * logits))).astype(np.float32)
        else:
            preds = logits
            if kind == "nan":
                preds[rng.random(shape) < 0.05] = np.nan
        target = rng.integers(0, 2, shape)
        if ignore_index is not None:
            target[rng.random(shape) < 0.15] = ignore_index
        out.append((preds, target, jax_scores(preds, thresholds)))
    return out


def _pair(name: str, **kwargs):
    return lambda: getattr(tc, name)(**kwargs, device="cpu"), lambda: getattr(jc, name)(**kwargs)


# ------------------------------------------------------------------ stat-scores family


@pytest.mark.parametrize("name", STAT_CLASSES)
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_stat_scores_family_global(name, kind, ignore_index):
    make_port, make_ref = _pair(name, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(3, kind, ignore_index), RATIO_ATOL)


@pytest.mark.parametrize("name", STAT_CLASSES)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_stat_scores_family_samplewise(name, ignore_index):
    make_port, make_ref = _pair(name, multidim_average="samplewise", ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(5, "logits", ignore_index, extra=7), RATIO_ATOL)


@pytest.mark.parametrize("beta", [0.5, 2.0])
@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_fbeta_and_threshold(beta, threshold):
    make_port, make_ref = _pair("BinaryFBetaScore", beta=beta, threshold=threshold, ignore_index=-1)
    three_levels(make_port, make_ref, _batches(7, "probs", -1), RATIO_ATOL)


def test_nan_scores_count_as_negative():
    """A NaN among the scores sends the whole batch through the sigmoid, and NaN > t is
    false in both packages."""
    make_port, make_ref = _pair("BinaryStatScores")
    batches = _batches(9, "nan")
    assert any(np.isnan(p).any() for p, _, _ in batches)
    three_levels(make_port, make_ref, batches, RATIO_ATOL)


@pytest.mark.parametrize(
    ("port_fn", "ref_fn", "kwargs"),
    [
        (tf.binary_stat_scores, jf.binary_stat_scores, {}),
        (tf.binary_accuracy, jf.binary_accuracy, dict(multidim_average="samplewise")),
        (tf.binary_precision, jf.binary_precision, dict(ignore_index=-1)),
        (tf.binary_recall, jf.binary_recall, dict(threshold=0.25)),
        (tf.binary_fbeta_score, jf.binary_fbeta_score, dict(beta=2.0, ignore_index=-1)),
        (tf.binary_f1_score, jf.binary_f1_score, {}),
        (tf.binary_confusion_matrix, jf.binary_confusion_matrix, dict(normalize="true", ignore_index=-1)),
    ],
)
def test_functional_stat_scores_family(port_fn, ref_fn, kwargs):
    extra = 5 if kwargs.get("multidim_average") == "samplewise" else 0
    for preds, target, jpreds in _batches(11, "logits", -1 if "ignore_index" in kwargs else None, extra):
        assert_close(
            port_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
            ref_fn(jnp.asarray(jpreds), jnp.asarray(target), **kwargs),
            RATIO_ATOL,
        )


# ------------------------------------------------------------------ confusion matrix


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_confusion_matrix(normalize, kind, ignore_index):
    make_port, make_ref = _pair("BinaryConfusionMatrix", normalize=normalize, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(13, kind, ignore_index, extra=3), RATIO_ATOL)


def test_confusion_matrix_forward_in_a_collection_gives_the_batch_value():
    """The reduce-state ``forward`` of a collection holding a confusion matrix beside the
    stat-scores family: every batch value as the JAX package's collection gives it."""
    from torchmetrics_tpu import MetricCollection as JaxMetricCollection

    names = {"cm": "BinaryConfusionMatrix", "acc": "BinaryAccuracy", "f1": "BinaryF1Score"}
    port = MetricCollection({k: getattr(tc, v)(device="cpu", ignore_index=-1) for k, v in names.items()})
    ref = JaxMetricCollection({k: getattr(jc, v)(ignore_index=-1) for k, v in names.items()})
    for preds, target, jpreds in _batches(15, "logits", -1):
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        want = ref(jnp.asarray(jpreds), jnp.asarray(target))
        assert sorted(got) == sorted(want)
        for key in got:
            assert_close(got[key], want[key], RATIO_ATOL, msg=key)
    for key, value in port.compute().items():
        assert_close(value, ref.compute()[key], RATIO_ATOL, msg=key)


# ------------------------------------------------------------------ curve family

CURVES = ["BinaryPrecisionRecallCurve", "BinaryROC", "BinaryAUROC", "BinaryAveragePrecision"]
THRESHOLDS = [None, 11, [0.0, 0.2, 0.5, 0.5, 0.8, 1.0], "tensor"]


def _thresholds(spec):
    return torch.linspace(0.05, 0.95, 9) if spec == "tensor" else spec


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=["exact", "int", "list", "tensor"])
@pytest.mark.parametrize(("kind", "ignore_index"), [("logits", -1), ("probs", None), ("peaked", -1)])
def test_curve_family(name, thresholds, kind, ignore_index):
    thr = _thresholds(thresholds)
    make_port = lambda: getattr(tc, name)(thresholds=thr, ignore_index=ignore_index, device="cpu")  # noqa: E731
    jthr = jnp.asarray(thr.numpy()) if isinstance(thr, torch.Tensor) else thr
    make_ref = lambda: getattr(jc, name)(thresholds=jthr, ignore_index=ignore_index)  # noqa: E731
    batches = _batches(17, kind, ignore_index, thresholds=thr.numpy() if isinstance(thr, torch.Tensor) else thr)
    three_levels(make_port, make_ref, batches, CURVE_ATOL, float_state_atol=SIGMOID_ATOL)


@pytest.mark.parametrize("max_fpr", [0.05, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("thresholds", [None, 50])
def test_auroc_max_fpr(max_fpr, thresholds):
    """The McClish-corrected partial AUC (``max_fpr``), exact and binned."""
    make_port, make_ref = _pair("BinaryAUROC", max_fpr=max_fpr, thresholds=thresholds, ignore_index=-1)
    three_levels(make_port, make_ref, _batches(19, "logits", -1, thresholds=thresholds), CURVE_ATOL, float_state_atol=SIGMOID_ATOL)


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("thresholds", [None, 11])
def test_curve_family_nan_scores(name, thresholds):
    make_port, make_ref = _pair(name, thresholds=thresholds)
    batches = _batches(21, "nan", thresholds=thresholds)
    port, ref = make_port(), make_ref()
    for preds, target, jpreds in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
    if thresholds is not None:  # NaN scores count below every threshold
        assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), CURVE_ATOL)


@pytest.mark.parametrize(
    ("port_fn", "ref_fn", "kwargs"),
    [
        (tf.binary_precision_recall_curve, jf.binary_precision_recall_curve, dict(thresholds=7)),
        (tf.binary_roc, jf.binary_roc, dict(thresholds=None, ignore_index=-1)),
        (tf.binary_auroc, jf.binary_auroc, dict(max_fpr=0.4)),
        (tf.binary_auroc, jf.binary_auroc, dict(thresholds=[0.1, 0.4, 0.6])),
        (tf.binary_average_precision, jf.binary_average_precision, dict(ignore_index=-1)),
        (tf.binary_average_precision, jf.binary_average_precision, dict(thresholds=20)),
    ],
)
def test_functional_curve_family(port_fn, ref_fn, kwargs):
    for preds, target, jpreds in _batches(23, "logits", kwargs.get("ignore_index"), thresholds=kwargs.get("thresholds")):
        assert_close(
            port_fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
            ref_fn(jnp.asarray(jpreds), jnp.asarray(target), **kwargs),
            CURVE_ATOL,
        )


def test_sync_through_injected_gather_exact_auroc():
    """A two-rank world emulated by a gather that returns the local state twice: the
    exact AUROC's cat lists fold as the JAX package folds them."""
    sync = dict(dist_sync_fn=lambda x, group=None: [x, x], distributed_available_fn=lambda: True)
    port, ref = tc.BinaryAUROC(**sync, device="cpu"), jc.BinaryAUROC(**sync)
    for preds, target, _ in _batches(25, "probs"):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(port.compute(), ref.compute(), CURVE_ATOL)
    assert_states(port, ref)


# ------------------------------------------------------------------ K2 at C = 1


@pytest.mark.parametrize("kind", ["random", "peaked", "on_threshold"])
@pytest.mark.parametrize("t", [5, 200])
def test_k2_plain_at_one_class_matches_jax(kind, t):
    """The binned binary update's K2 call, ``(N, 1)`` scores, positives and mask, against
    the JAX package's ``_binned_multi_threshold_confmat`` on the same inputs."""
    rng = np.random.default_rng(t)
    n = 4099
    with jax.enable_x64(False):
        thr = np.asarray(jnp.linspace(0, 1, t))
    logits = rng.standard_normal(n).astype(np.float32)
    preds = (1 / (1 + np.exp(-(8 if kind == "peaked" else 1) * logits))).astype(np.float32)
    if kind == "on_threshold":
        preds = thr[rng.integers(0, t, n)]
    preds[rng.random(n) < 0.01] = np.nan
    target = rng.integers(0, 2, n)
    target[rng.random(n) < 0.05] = -1
    p, tg = torch.from_numpy(preds), torch.from_numpy(target)
    got = _binned_multi_threshold_confmat(p[:, None], (tg > 0)[:, None], (tg >= 0)[:, None], sort_thresholds(torch.from_numpy(thr)))
    want = jax_binned_confmat(
        jnp.asarray(preds)[:, None], jnp.asarray(target > 0)[:, None], jnp.asarray(target >= 0)[:, None], jnp.asarray(thr)
    )
    assert got.shape == (t, 1, 2, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(("n", "c"), [(1 << 20, 1), (8192, 80)])
def test_launch_plan_of_the_new_paths(n, c):
    """K2's plan for an H100 (132 SMs, 227 KB of opt-in shared memory) at the binary
    path's ``(2^20, 1, 200)`` and the multilabel path's ``(8192, 80, 200)``: the rows
    are covered, the shared memory fits and the grid fills the card."""
    from torchmetrics_tpu_torch.ops.multi_threshold import _STATIC_SMEM, _make_plan

    plan = _make_plan(n, c, 200, 132, 232448 - _STATIC_SMEM)
    tiles = -(-c // (1 << plan.tw_log))
    assert plan.smem and plan.rows_per_chunk * plan.row_chunks >= n > plan.rows_per_chunk * (plan.row_chunks - 1)
    assert tiles * plan.row_chunks >= 4 * 132 * 0.9, plan
    assert plan.scratch_words >= c * 201


# ------------------------------------------------------------------ sigmoid and syncs


def test_sigmoid_difference_is_bounded():
    """``torch.sigmoid`` against ``jax.nn.sigmoid`` on float32 logits: at most two ulp
    apart, and on under 1 % of them (a few tenths of a percent on these seeds)."""
    for seed, scale in ((0, 1.0), (1, 3.0), (2, 10.0)):
        x = (np.random.default_rng(seed).standard_normal(200_000) * scale).astype(np.float32)
        j = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
        t = torch.sigmoid(torch.from_numpy(x)).numpy()
        ulps = np.abs(j.view(np.int32).astype(np.int64) - t.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2 and np.abs(j - t).max() <= SIGMOID_ATOL
        assert (ulps != 0).mean() < 0.01


def test_sigmoid_choice_stays_on_the_device():
    """``_sigmoid_if_logits`` picks the sigmoid with ``torch.where`` on a device boolean:
    it runs on shapes alone (the meta device holds no values to read back)."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits

    x = torch.empty(1000, device="meta")
    assert _sigmoid_if_logits(x).shape == (1000,)
    probs = torch.tensor([0.0, 0.5, 1.0])
    assert torch.equal(_sigmoid_if_logits(probs), probs)
    logits = torch.tensor([-2.0, 0.5, 3.0])
    assert torch.equal(_sigmoid_if_logits(logits), torch.sigmoid(logits))


def test_exact_auroc_class_weights_need_no_boolean_index():
    """The exact-mode class weights count the targets with ``-1`` in ``_bincount``'s
    dropped bin: the values of the old boolean-index count, with no data-dependent shape
    (the meta device cannot run a ``nonzero``)."""
    from torchmetrics_tpu_torch.functional.classification.auroc import _class_weights
    from torchmetrics_tpu_torch.utilities.data import _bincount

    target = torch.from_numpy(np.random.default_rng(27).integers(-1, 5, 500))
    old = _bincount(target[target >= 0], minlength=5).to(torch.float32)
    assert torch.equal(_class_weights((torch.rand(500, 5), target), 5), old)
    meta = torch.empty(500, dtype=torch.int64, device="meta")
    assert _class_weights((torch.empty(500, 5, device="meta"), meta), 5).shape == (5,)
    with pytest.raises(NotImplementedError):
        meta[meta >= 0]


def test_binary_updates_without_validation_read_nothing_back(monkeypatch):
    """With ``validate_args=False`` the stat-scores and confusion-matrix updates never
    turn a device tensor into a Python value (``bool`` / ``int`` / ``float`` / ``item``)."""
    metrics = [tc.BinaryF1Score(validate_args=False, device="cpu"), tc.BinaryConfusionMatrix(validate_args=False, device="cpu")]
    preds, target, _ = _batches(29, "logits", None)[0]
    preds, target = torch.from_numpy(preds), torch.from_numpy(target)
    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, _forbidden(name))
    for metric in metrics:
        metric.update(preds, target)


def _forbidden(name):
    def fn(self, *args, **kwargs):
        raise AssertionError(f"Tensor.{name} called in an update that must not sync")

    return fn


# ------------------------------------------------------------------ collection


def _collection_members(port: bool, thresholds: int = 20) -> dict:
    """The binary path's collection (``chip_smoke.py``) at a small size."""
    mod, extra = (tc, dict(device="cpu")) if port else (jc, {})
    return {
        "auroc": mod.BinaryAUROC(thresholds=thresholds, **extra),
        "ap": mod.BinaryAveragePrecision(thresholds=thresholds, **extra),
        "acc": mod.BinaryAccuracy(**extra),
        "f1": mod.BinaryF1Score(**extra),
        "precision": mod.BinaryPrecision(**extra),
        "recall": mod.BinaryRecall(**extra),
        "cm": mod.BinaryConfusionMatrix(**extra),
        "auroc_exact": mod.BinaryAUROC(**extra),
    }


def test_collection_groups_states_and_values_match_jax(monkeypatch):
    """Groups after the first update equal the JAX package's; the port already has them
    when built for the signature members (the binned AUROC and AP merge by their
    thresholds), so K2 runs once per update from the first."""
    from torchmetrics_tpu import MetricCollection as JaxMetricCollection
    # the package exports a function of the module's name, so fetch the module itself
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    calls = []
    real = prc.multi_threshold_confmat
    monkeypatch.setattr(prc, "multi_threshold_confmat", lambda *a: calls.append(1) or real(*a))
    port = MetricCollection(_collection_members(True))
    ref = JaxMetricCollection(_collection_members(False))
    assert {frozenset(g) for g in port.compute_groups.values()} == {
        frozenset({"auroc", "ap"}), frozenset({"acc", "f1", "precision", "recall"}), frozenset({"cm"}),
        frozenset({"auroc_exact"}),
    }
    for i, (preds, target, jpreds) in enumerate(_batches(31, "logits", thresholds=20)):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
        assert len(calls) == i + 1
        assert {frozenset(g) for g in port.compute_groups.values()} == {frozenset(g) for g in ref.compute_groups.values()}
    for name, metric in port.items(keep_base=True):
        assert_states(metric, ref[name], SIGMOID_ATOL)
    want = ref.compute()
    for key, value in port.compute().items():
        assert_close(value, want[key], CURVE_ATOL, msg=key)
