"""Jaccard index, Matthews correlation coefficient and Cohen's kappa: the port (on the
CPU) against the JAX package.

All three are confusion-matrix metrics: the update is the confusion matrix's count
(integer states, held exactly), the compute reduces the matrix. Every task takes the
same seeded numpy batches as the JAX package at the three protocol levels
(``torch_parity.three_levels``), over ragged batches, with and without
``ignore_index``, for every ``average`` and ``weights``, with logits, probabilities
and labels. Pinned edge cases: ``ignore_index == num_classes`` in micro and macro
Jaccard (the JAX package clamps ``denom[C]`` to ``denom[C - 1]`` and drops the write
``weights[C] = 0``; the port copies that), and MCC's degenerate cases (only true
positives, only true negatives, a zero denominator).

Tolerances: confusion matrices exact; Jaccard 1e-6 (float32 ratios of equal counts,
the macro mean summed in another order); MCC 1e-6 (float64 on both sides from equal
counts, rounded to float32); Cohen's kappa relative 2e-6 with 1e-6 absolute. Kappa's
weighted sums over the ``C * C`` float32 cells run in another order than XLA's; the
largest relative difference seen was 2.0e-7 at C = 10 and 5.0e-7 at C = 1000
(``test_kappa_tolerance_at_wide_c``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.classification as tf
from tests.torch_parity import assert_close, assert_states, jax_scores, three_levels
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.interop import state_from_jax

ATOL = 1e-6
KAPPA_RTOL = 2e-6
C, L = 5, 4
SIZES = (48, 37, 64, 21)
AVERAGES = ["micro", "macro", "weighted", "none"]
PREFIX = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}


def _batches(task: str, seed: int, kind: str = "logits", ignore_index=None, hit: float = 0.5):
    """``(port preds, target, JAX preds)``; multiclass predictions agree with the target
    on about ``hit`` of the rows (kappa and MCC away from 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        shape = {"binary": (n,), "multiclass": (n, C), "multilabel": (n, L)}[task]
        tshape = (n,) if task != "multilabel" else (n, L)
        width = C if task == "multiclass" else 2
        target = rng.integers(0, width, tshape)
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        if task == "multiclass":
            logits[np.arange(n), target] += 3 * (rng.random(n) < hit)
        if kind == "labels":
            preds = np.where(rng.random(tshape) < hit, target, rng.integers(0, width, tshape))
        elif kind == "probs" and task == "multiclass":
            e = np.exp(logits - logits.max(1, keepdims=True))
            preds = (e / e.sum(1, keepdims=True)).astype(np.float32)
        elif kind == "probs":
            preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
        else:
            preds = logits
        if ignore_index is not None:
            target = target.copy()
            target[rng.random(tshape) < 0.15] = ignore_index
        out.append((preds, target, jax_scores(preds) if task != "multiclass" else preds))
    return out


def _pair(name: str, task: str, **kwargs):
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    width.update(kwargs.pop("width", {}))
    return (
        lambda: getattr(tc, PREFIX[task] + name)(**width, **kwargs, device="cpu"),
        lambda: getattr(jc, PREFIX[task] + name)(**width, **kwargs),
    )


# ------------------------------------------------------------------ Jaccard


@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_binary_jaccard(kind, ignore_index, threshold):
    make_port, make_ref = _pair("JaccardIndex", "binary", threshold=threshold, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("binary", 1, kind, ignore_index), ATOL)


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1, 0, 2])
def test_multiclass_jaccard(average, kind, ignore_index):
    make_port, make_ref = _pair("JaccardIndex", "multiclass", average=average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multiclass", 2, kind, ignore_index), ATOL, ATOL)


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_jaccard(average, kind, ignore_index):
    make_port, make_ref = _pair("JaccardIndex", "multilabel", average=average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multilabel", 3, kind, ignore_index), ATOL, ATOL)


@pytest.mark.parametrize("average", ["micro", "macro"])
def test_jaccard_ignore_index_equal_to_num_classes(average):
    """``ignore_index == num_classes`` passes the JAX package's ``<=`` check: micro
    subtracts the last class's denominator (JAX clamps ``denom[C]``), macro keeps every
    class's weight (JAX drops ``weights[C] = 0``). The port gives those values, not the
    unclamped ones."""
    make_port, make_ref = _pair("JaccardIndex", "multiclass", average=average, ignore_index=C)
    batches = _batches("multiclass", 4, "labels", ignore_index=C)
    three_levels(make_port, make_ref, batches, ATOL, ATOL)
    port = make_port()
    for preds, target, _ in batches:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    confmat = port.confmat.to(torch.float64)
    num = confmat.diagonal()
    denom = confmat.sum(0) + confmat.sum(1) - num
    if average == "micro":
        unclamped = float(num.sum() / denom.sum())  # nothing to subtract at index C
        want = float(num.sum() / (denom.sum() - denom[C - 1]))
    else:
        unclamped = float((num / denom).mean())
        want = unclamped  # no weight is zeroed
    assert float(port.compute()) == pytest.approx(want, abs=ATOL)
    if average == "micro":
        assert abs(float(port.compute()) - unclamped) > 1e-3


def test_jaccard_reference_example():
    """C = 4, ``ignore_index = 4``, micro: eight counted rows, two of them right, so the
    denominators sum to 14; the JAX package subtracts ``denom[3] = 3`` and gives 2 / 11,
    where the unclamped formula gives 2 / 14."""
    preds = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 1, 2])
    target = torch.tensor([0, 2, 1, 3, 4, 4, 3, 2, 0, 1])
    got = tf.multiclass_jaccard_index(preds, target, num_classes=4, average="micro", ignore_index=4)
    want = jf.multiclass_jaccard_index(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()), 4, "micro", 4)
    assert_close(got, want, ATOL)
    assert float(got) == pytest.approx(2 / 11, abs=ATOL)


# ------------------------------------------------------------------ MCC


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_matthews_corrcoef(task, kind, ignore_index):
    make_port, make_ref = _pair("MatthewsCorrCoef", task, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(task, 5, kind, ignore_index), ATOL)


_DEGENERATE = {
    # binary (preds, target): only true positives -> 1, only true negatives -> -1,
    # every prediction positive with mixed targets -> a zero denominator
    "only-tp": ([1, 1, 1, 1], [1, 1, 1, 1]),
    "only-tn": ([0, 0, 0], [0, 0, 0]),
    "zero-denominator": ([1, 1, 1, 1], [1, 0, 1, 0]),
    "all-wrong": ([1, 0, 1, 0], [0, 1, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(_DEGENERATE))
def test_matthews_corrcoef_degenerate_cases(case):
    preds, target = (np.asarray(x) for x in _DEGENERATE[case])
    got = tf.binary_matthews_corrcoef(torch.from_numpy(preds), torch.from_numpy(target))
    want = jf.binary_matthews_corrcoef(jnp.asarray(preds), jnp.asarray(target))
    assert_close(got, want, ATOL)
    assert got.dtype == torch.float32
    if case == "only-tp":
        assert float(got) == 1.0
    if case == "only-tn":
        assert float(got) == -1.0
    # the same rows as two labels of a multilabel matrix (summed into one 2 x 2)
    preds2, target2 = np.stack([preds, preds], 1), np.stack([target, target], 1)
    got = tf.multilabel_matthews_corrcoef(torch.from_numpy(preds2), torch.from_numpy(target2), num_labels=2)
    want = jf.multilabel_matthews_corrcoef(jnp.asarray(preds2), jnp.asarray(target2), num_labels=2)
    assert_close(got, want, ATOL)


def test_multiclass_matthews_corrcoef_zero_denominator():
    """Every prediction one class: a zero denominator at C > 2 gives 0."""
    target = torch.tensor([0, 1, 2, 1, 0])
    preds = torch.zeros(5, dtype=torch.int64)
    got = tf.multiclass_matthews_corrcoef(preds, target, num_classes=3)
    want = jf.multiclass_matthews_corrcoef(jnp.zeros(5, dtype=jnp.int64), jnp.asarray(target.numpy()), 3)
    assert_close(got, want, 0.0)
    assert float(got) == 0.0


# ------------------------------------------------------------------ Cohen's kappa


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("kind", ["logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_cohen_kappa(task, weights, kind, ignore_index):
    make_port, make_ref = _pair("CohenKappa", task, weights=weights, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches(task, 6, kind, ignore_index), ATOL, KAPPA_RTOL)


@pytest.mark.parametrize("num_classes", [10, 1000])
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
def test_kappa_tolerance_at_wide_c(num_classes, weights):
    """The stated relative tolerance holds at C = 10 and at C = 1000 (a 1000 x 1000
    matrix, the ImageNet width)."""
    rng = np.random.default_rng(num_classes)
    n = 20 * num_classes
    target = rng.integers(0, num_classes, n)
    preds = np.where(rng.random(n) < 0.6, target, rng.integers(0, num_classes, n))
    got = tf.multiclass_cohen_kappa(torch.from_numpy(preds), torch.from_numpy(target), num_classes, weights=weights)
    want = jf.multiclass_cohen_kappa(jnp.asarray(preds), jnp.asarray(target), num_classes, weights=weights)
    assert_close(got, want, 0.0, KAPPA_RTOL)


def test_kappa_refuses_unknown_weights():
    for port_call, ref_call in (
        (lambda: tc.BinaryCohenKappa(weights="cubic", device="cpu"), lambda: jc.BinaryCohenKappa(weights="cubic")),
        (
            lambda: tf.binary_cohen_kappa(torch.tensor([0, 1]), torch.tensor([0, 1]), weights="cubic"),
            lambda: jf.binary_cohen_kappa(jnp.asarray([0, 1]), jnp.asarray([0, 1]), weights="cubic"),
        ),
    ):
        with pytest.raises(ValueError) as port_err:
            port_call()
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------------ functional twins


_FUNCTIONAL = [
    ("jaccard_index", "binary", dict(threshold=0.3)),
    ("jaccard_index", "multiclass", dict(average="weighted", ignore_index=-1)),
    ("jaccard_index", "multilabel", dict(average="micro", ignore_index=-1)),
    ("matthews_corrcoef", "binary", dict(ignore_index=-1)),
    ("matthews_corrcoef", "multiclass", {}),
    ("matthews_corrcoef", "multilabel", dict(threshold=0.6)),
    ("cohen_kappa", "binary", dict(weights="linear")),
    ("cohen_kappa", "multiclass", dict(weights="quadratic", ignore_index=-1)),
]


@pytest.mark.parametrize(("family", "task", "kwargs"), _FUNCTIONAL)
def test_functional_and_router(family, task, kwargs):
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    for preds, target, jpreds in _batches(task, 7, "logits", kwargs.get("ignore_index")):
        p, t, jp, jt = torch.from_numpy(preds), torch.from_numpy(target), jnp.asarray(jpreds), jnp.asarray(target)
        want = getattr(jf, f"{task}_{family}")(jp, jt, **width, **kwargs)
        assert_close(getattr(tf, f"{task}_{family}")(p, t, **width, **kwargs), want, ATOL, KAPPA_RTOL, family)
        assert_close(getattr(tf, family)(p, t, task=task, **width, **kwargs), want, ATOL, KAPPA_RTOL, family)


# ------------------------------------------------------------------ one group, state carry


def test_confusion_matrix_family_shares_one_update():
    """Jaccard, MCC, kappa and a confusion matrix over the same ``num_classes`` and
    ``ignore_index`` declare one reduction signature: one group, one count per update,
    each value as the metric alone gives it."""
    members = {
        "cm": tc.MulticlassConfusionMatrix(C, ignore_index=-1, device="cpu"),
        "iou": tc.MulticlassJaccardIndex(C, ignore_index=-1, device="cpu"),
        "mcc": tc.MulticlassMatthewsCorrCoef(C, ignore_index=-1, device="cpu"),
        "kappa": tc.MulticlassCohenKappa(C, ignore_index=-1, weights="quadratic", device="cpu"),
        "iou_other": tc.MulticlassJaccardIndex(C, ignore_index=0, device="cpu"),
    }
    mc = MetricCollection(members)
    assert sorted(map(sorted, mc.compute_groups.values())) == [["cm", "iou", "kappa", "mcc"], ["iou_other"]]
    batches = _batches("multiclass", 8, "logits", -1)
    for preds, target, _ in batches:
        mc.update(torch.from_numpy(preds), torch.from_numpy(target))
    out = mc.compute()
    for name, cls in (("iou", "MulticlassJaccardIndex"), ("mcc", "MulticlassMatthewsCorrCoef")):
        alone = getattr(tc, cls)(C, ignore_index=-1, device="cpu")
        for preds, target, _ in batches:
            alone.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(out[name], alone.compute(), 0.0, msg=name)


@pytest.mark.parametrize(
    ("name", "task", "kwargs"),
    [
        ("JaccardIndex", "binary", {}),
        ("JaccardIndex", "multiclass", dict(average="macro")),
        ("JaccardIndex", "multilabel", dict(average="weighted")),
        ("MatthewsCorrCoef", "binary", {}),
        ("MatthewsCorrCoef", "multiclass", {}),
        ("MatthewsCorrCoef", "multilabel", {}),
        ("CohenKappa", "binary", {}),
        ("CohenKappa", "multiclass", dict(weights="linear")),
    ],
)
def test_state_carried_from_jax(name, task, kwargs):
    make_port, make_ref = _pair(name, task, ignore_index=-1, **kwargs)
    batches = _batches(task, 9, "probs", -1)
    ref = make_ref()
    ref.persistent(True)
    for _, target, jpreds in batches[:2]:
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
    port = make_port()
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    for preds, target, jpreds in batches[2:]:
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), ATOL, KAPPA_RTOL)
