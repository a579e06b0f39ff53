"""Recall at fixed precision, precision at fixed recall and specificity at sensitivity:
the port (on the CPU) against the JAX package.

The three families keep the PR curve's states (kernel K2's binned ``(T, [C,] 2, 2)``
confusion tensor, or exact score lists) and choose an operating point on the host at
compute time. Every task takes the same seeded numpy batches as the JAX package at the
three protocol levels (``torch_parity.three_levels``), over ragged batches, with
thresholds as an int, a list, a tensor or None (exact mode), with and without
``ignore_index``, on probabilities and logits. Pinned: a point that sits on the floor
(a precision of exactly 0.5, and 7 / 10 against a floor of 0.7, which float32 puts
below it), no qualifying point (``(0, 1e6)``), a best objective of 0 (threshold
``1e6``), the fixed-precision tie order (the last point of a ``lexsort`` over
objective, constraint and threshold) and the specificity tie order (the first of the
maxima).

Tolerances: binned mode exact, values and thresholds alike (the counts and the float32
thresholds are bit-equal, so the curves are); exact mode 1e-5 on values (JAX's 64-bit
mode computes the exact curve in float64), thresholds exact (both are the scores).
Binned cases run the JAX package in 32-bit mode: in 64-bit mode its thresholds are
float64, and a float32 score that sits on a threshold (0.35 here) bins below it.
"""

from __future__ import annotations

from contextlib import nullcontext

import jax
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

EXACT_ATOL = 1e-5
C, L = 4, 3
SIZES = (48, 37, 48, 37)  # ragged; two sizes keep the JAX side's exact-mode compiles few
PREFIX = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}
FAMILIES = {
    "RecallAtFixedPrecision": ("min_precision", "recall_at_fixed_precision"),
    "PrecisionAtFixedRecall": ("min_recall", "precision_at_fixed_recall"),
    "SpecificityAtSensitivity": ("min_sensitivity", "specificity_at_sensitivity"),
}
THRESHOLDS = {"int": 11, "list": [0.0, 0.2, 0.35, 0.5, 0.65, 0.8, 1.0], "tensor": "tensor", "exact": None}


def _jax_mode(thresholds):
    """32-bit JAX for binned curves (float32 thresholds, as the port's), 64-bit for exact."""
    return nullcontext() if thresholds is None or thresholds == "exact" else jax.enable_x64(False)


def _thresholds(key: str, port: bool):
    value = THRESHOLDS[key]
    if value == "tensor":
        arr = np.linspace(0, 1, 9, dtype=np.float32)
        return torch.from_numpy(arr) if port else jnp.asarray(arr)
    return value


def _batches(task: str, seed: int, kind: str = "probs", ignore_index=None, thresholds=None):
    """``(port preds, target, JAX preds)``; scores are rounded to 0.05 in ``probs`` so
    the curves hold ties and points that land on thresholds."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        if task == "multiclass":
            target = rng.integers(0, C, n)
            logits = rng.standard_normal((n, C)).astype(np.float32)
            logits[np.arange(n), target] += 1.5
            e = np.exp(logits - logits.max(1, keepdims=True))
            preds = (e / e.sum(1, keepdims=True)).astype(np.float32) if kind == "probs" else logits
        else:
            shape = (n,) if task == "binary" else (n, L)
            target = rng.integers(0, 2, shape)
            logits = (rng.standard_normal(shape) + 1.2 * (2 * target - 1)).astype(np.float32)
            preds = np.round(1 / (1 + np.exp(-logits)) * 20) / 20 if kind == "probs" else logits
            preds = preds.astype(np.float32)
        if ignore_index is not None:
            target = target.copy()
            target[rng.random(target.shape) < 0.15] = ignore_index
        jpreds = preds if task == "multiclass" else jax_scores(preds, thresholds)
        out.append((preds, target, jpreds))
    return out


def _pair(family: str, task: str, floor: float, thresholds: str, **kwargs):
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    arg = FAMILIES[family][0]
    return (
        lambda: getattr(tc, PREFIX[task] + family)(
            **width, **{arg: floor}, thresholds=_thresholds(thresholds, True), **kwargs, device="cpu"
        ),
        lambda: getattr(jc, PREFIX[task] + family)(
            **width, **{arg: floor}, thresholds=_thresholds(thresholds, False), **kwargs
        ),
    )


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("thresholds", sorted(THRESHOLDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_three_levels(family, task, thresholds, ignore_index):
    make_port, make_ref = _pair(family, task, 0.5, thresholds, ignore_index=ignore_index)
    batches = _batches(task, 1, "probs", ignore_index, THRESHOLDS[thresholds] if thresholds != "tensor" else 9)
    atol = 0.0 if thresholds != "exact" else EXACT_ATOL
    with _jax_mode(thresholds):
        three_levels(make_port, make_ref, batches, atol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("floor", [0.0, 0.3, 0.8, 1.0])
def test_floors_on_logits(family, task, floor):
    """Logits (a sigmoid, or a softmax for multiclass) and floors from 0 to 1, binned
    at 11 thresholds, with ``ignore_index``."""
    make_port, make_ref = _pair(family, task, floor, "int", ignore_index=-1)
    batches = _batches(task, 2, "logits", -1, thresholds=THRESHOLDS["int"])
    with _jax_mode("int"):
        three_levels(make_port, make_ref, batches, 0.0)


# ------------------------------------------------------------------ pinned edge cases


def _binary_both(family: str, preds, target, floor: float, thresholds):
    fn = FAMILIES[family][1]
    arg = FAMILIES[family][0]
    got = getattr(tf, "binary_" + fn)(torch.tensor(preds), torch.tensor(target), **{arg: floor}, thresholds=thresholds)
    with _jax_mode(thresholds):
        want = getattr(jf, "binary_" + fn)(
            jnp.asarray(preds, dtype=jnp.float32), jnp.asarray(target), **{arg: floor}, thresholds=thresholds
        )
    assert_close(got, want, 0.0, msg=family)
    return tuple(float(v) for v in got)


def test_precision_on_the_floor():
    """At thresholds 0.0 and 0.5 the precision is 2 / 4 = 0.5 exactly: both qualify for a
    floor of 0.5 and tie on recall 1, so the higher threshold wins (the last point of
    the ``lexsort``)."""
    preds, target = [0.9, 0.8, 0.7, 0.6], [1, 0, 1, 0]
    assert _binary_both("RecallAtFixedPrecision", preds, target, 0.5, [0.0, 0.5, 0.75, 0.85, 1.0]) == (1.0, 0.5)


def test_float32_point_below_a_float64_floor():
    """Precision 7 / 10 is 0.69999999 in float32, under the float64 floor 0.7: the point
    does not qualify in either package, and the next one (precision 1) does."""
    preds = [0.95] * 7 + [0.9] * 3 + [0.3] * 4
    target = [1] * 7 + [0] * 3 + [1] * 4
    thresholds = [0.5, 0.92]
    assert float(np.float32(7) / np.float32(10)) < 0.7
    assert _binary_both("RecallAtFixedPrecision", preds, target, 0.7, thresholds) == pytest.approx(
        (7 / 11, np.float32(0.92))
    )


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_qualifying_point(family):
    """A floor no point reaches gives ``(0, 1e6)``."""
    preds, target = [0.9, 0.8, 0.7, 0.6], [0, 0, 0, 1]
    value, threshold = _binary_both(family, preds, target, 1.0, [0.95, 1.0])
    assert (value, threshold) == (0.0, 1e6)


def test_best_objective_zero_gives_threshold_1e6():
    """Every qualifying point has recall 0: the threshold is 1e6, not the point's."""
    preds, target = [0.9, 0.8, 0.7], [0, 0, 1]
    assert _binary_both("RecallAtFixedPrecision", preds, target, 0.0, [0.85, 0.95]) == (0.0, 1e6)


def test_specificity_tie_takes_the_first_point():
    """Three thresholds give specificity 1 with sensitivity over the floor: the first of
    them in the ROC's order (thresholds descending) is chosen, not the last."""
    preds, target = [0.9, 0.8, 0.2, 0.1], [1, 1, 0, 0]
    value, threshold = _binary_both("SpecificityAtSensitivity", preds, target, 0.5, [0.3, 0.5, 0.7, 0.95])
    assert (value, threshold) == (1.0, np.float32(0.7))


def test_recall_tie_takes_the_last_point():
    """Tied recall and precision at several thresholds: the highest threshold wins."""
    preds, target = [0.9, 0.8, 0.2, 0.1], [1, 1, 0, 0]
    value, threshold = _binary_both("RecallAtFixedPrecision", preds, target, 0.5, [0.3, 0.5, 0.7, 0.95])
    assert (value, threshold) == (1.0, np.float32(0.7))


# ------------------------------------------------------------------ functional, routers, groups


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("thresholds", ["int", "exact"])
def test_functional_and_router(family, task, thresholds):
    arg, fn = FAMILIES[family]
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    atol = 0.0 if thresholds != "exact" else EXACT_ATOL
    thr = THRESHOLDS[thresholds]
    for preds, target, jpreds in _batches(task, 3, "logits", -1, thr):
        p, t, jp, jt = torch.from_numpy(preds), torch.from_numpy(target), jnp.asarray(jpreds), jnp.asarray(target)
        kwargs = dict(**{arg: 0.5}, thresholds=thr, ignore_index=-1)
        with _jax_mode(thr):
            want = getattr(jf, f"{task}_{fn}")(jp, jt, **width, **kwargs)
        assert_close(getattr(tf, f"{task}_{fn}")(p, t, **width, **kwargs), want, atol, msg=fn)
        assert_close(getattr(tf, fn)(p, t, task=task, **width, **kwargs), want, atol, msg=fn)


def test_reference_alias():
    assert tf.specicity_at_sensitivity is tf.specificity_at_sensitivity


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_collection_counts_once_for_every_curve(task):
    """An AUROC and the three fixed-point metrics over the same thresholds are one group
    when built; each value is the one the metric gives alone."""
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    kw = dict(thresholds=20, ignore_index=-1, device="cpu", **width)
    members = {
        "auroc": getattr(tc, PREFIX[task] + "AUROC")(**kw),
        "rfp": getattr(tc, PREFIX[task] + "RecallAtFixedPrecision")(min_precision=0.5, **kw),
        "pfr": getattr(tc, PREFIX[task] + "PrecisionAtFixedRecall")(min_recall=0.5, **kw),
        "sas": getattr(tc, PREFIX[task] + "SpecificityAtSensitivity")(min_sensitivity=0.5, **kw),
    }
    mc = MetricCollection(members)
    assert mc.compute_groups == {0: ["auroc", "pfr", "rfp", "sas"]}
    batches = _batches(task, 4, "probs", -1)
    for preds, target, _ in batches:
        mc.update(torch.from_numpy(preds), torch.from_numpy(target))
    out = mc.compute()
    for name, cls in (("rfp", "RecallAtFixedPrecision"), ("pfr", "PrecisionAtFixedRecall")):
        alone = getattr(tc, PREFIX[task] + cls)(**{FAMILIES[cls][0]: 0.5}, **kw)
        for preds, target, _ in batches:
            alone.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(out[name], alone.compute(), 0.0, msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("thresholds", ["int", "exact"])
def test_state_carried_from_jax(family, task, thresholds):
    make_port, make_ref = _pair(family, task, 0.5, thresholds, ignore_index=-1)
    batches = _batches(task, 5, "probs", -1)
    with _jax_mode(thresholds):
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
        assert_close(port.compute(), ref.compute(), 0.0 if thresholds != "exact" else EXACT_ATOL)


def test_arguments_are_validated_as_in_the_jax_package():
    for family, (arg, _) in FAMILIES.items():
        for bad in (1.5, 1, "0.5"):
            with pytest.raises(ValueError) as port_err:
                getattr(tc, "Binary" + family)(**{arg: bad}, device="cpu")
            with pytest.raises(ValueError) as ref_err:
                getattr(jc, "Binary" + family)(**{arg: bad})
            assert str(port_err.value) == str(ref_err.value)
