"""Exact match: the port (on the CPU) against the JAX package.

A sample matches when all its positions do: the multidim positions of a multiclass
``(N, C, ...)`` / ``(N, ...)`` input, or the labels of a multilabel one. Ignored
positions count as matching in both tasks; there is no binary task. Every task takes
the same seeded numpy batches as the JAX package at the three protocol levels
(``torch_parity.three_levels``), over ragged batches, with and without
``ignore_index``, globally and samplewise (where ``correct`` is a cat list and
``total`` a mean-reduced count, as in the JAX package), with logits, probabilities and
labels. The functional twins, the router's refusals and the state carried from the JAX
package in both modes are held too.

Tolerances: ``correct`` and ``total`` exact; ratios 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.classification as tf
from tests.torch_parity import assert_close, assert_states, jax_scores, three_levels
from torchmetrics_tpu_torch.interop import state_from_jax

ATOL = 1e-6
C, L, X = 3, 3, 4
SIZES = (32, 17, 40, 9)


def _batches(task: str, seed: int, kind: str = "logits", ignore_index=None, extra: int = X, hit: float = 0.85):
    """``(port preds, target, JAX preds)``: predictions right at about ``hit`` of the
    positions, so that whole samples match often enough to count."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        if task == "multiclass":
            tshape = (n, extra) if extra else (n,)
            target = rng.integers(0, C, tshape)
            labels = np.where(rng.random(tshape) < hit, target, rng.integers(0, C, tshape))
            if kind == "labels":
                preds = labels
            else:
                logits = rng.standard_normal((n, C, *tshape[1:])).astype(np.float32)
                np.put_along_axis(logits, labels[:, None], 4.0, axis=1)
                preds = logits
        else:
            shape = (n, L, extra) if extra else (n, L)
            target = rng.integers(0, 2, shape)
            labels = np.where(rng.random(shape) < hit, target, 1 - target)
            logits = ((2 * labels - 1) * (1 + rng.random(shape))).astype(np.float32)
            preds = labels if kind == "labels" else logits if kind == "logits" else 1 / (1 + np.exp(-logits))
            preds = preds.astype(np.float32) if kind != "labels" else preds
        if ignore_index is not None:
            target = target.copy()
            target[rng.random(target.shape) < 0.1] = ignore_index
        out.append((preds, target, preds if task == "multiclass" else jax_scores(preds)))
    return out


def _pair(task: str, **kwargs):
    if task == "multiclass":
        return (
            lambda: tc.MulticlassExactMatch(num_classes=C, **kwargs, device="cpu"),
            lambda: jc.MulticlassExactMatch(num_classes=C, **kwargs),
        )
    return (
        lambda: tc.MultilabelExactMatch(num_labels=L, **kwargs, device="cpu"),
        lambda: jc.MultilabelExactMatch(num_labels=L, **kwargs),
    )


@pytest.mark.parametrize("kind", ["logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multiclass(kind, ignore_index, multidim_average):
    make_port, make_ref = _pair("multiclass", multidim_average=multidim_average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multiclass", 1, kind, ignore_index), ATOL)


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_single_position(ignore_index):
    """``(N, C)`` scores against ``(N,)`` targets: one position per sample."""
    make_port, make_ref = _pair("multiclass", ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multiclass", 2, "logits", ignore_index, extra=0), ATOL)


@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel(kind, ignore_index, multidim_average):
    make_port, make_ref = _pair("multilabel", multidim_average=multidim_average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multilabel", 3, kind, ignore_index), ATOL)


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.3, 0.7])
def test_multilabel_flat(ignore_index, threshold):
    """``(N, L)`` inputs, thresholds either side of 0.5."""
    make_port, make_ref = _pair("multilabel", threshold=threshold, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multilabel", 4, "probs", ignore_index, extra=0), ATOL)


def test_ignored_positions_count_as_matching():
    """A sample whose only wrong position is ignored matches, in both tasks."""
    target = torch.tensor([[0, 1, 2], [2, 2, 1]])
    preds = torch.tensor([[0, 1, 0], [2, 2, 1]])
    assert float(tf.multiclass_exact_match(preds, target, num_classes=3)) == 0.5
    target[0, 2] = -1
    assert float(tf.multiclass_exact_match(preds, target, num_classes=3, ignore_index=-1)) == 1.0
    ml_target = torch.tensor([[1, 0, 1], [0, 0, 1]])
    ml_preds = torch.tensor([[1, 1, 1], [0, 0, 1]])
    assert float(tf.multilabel_exact_match(ml_preds, ml_target, num_labels=3)) == 0.5
    ml_target[0, 1] = -1
    assert float(tf.multilabel_exact_match(ml_preds, ml_target, num_labels=3, ignore_index=-1)) == 1.0


_FUNCTIONAL = [
    ("multiclass", dict(multidim_average="global")),
    ("multiclass", dict(multidim_average="samplewise", ignore_index=-1)),
    ("multilabel", dict(multidim_average="global", ignore_index=-1)),
    ("multilabel", dict(multidim_average="samplewise", threshold=0.4)),
]


@pytest.mark.parametrize(("task", "kwargs"), _FUNCTIONAL)
def test_functional_and_router(task, kwargs):
    width = dict(num_classes=C) if task == "multiclass" else dict(num_labels=L)
    for preds, target, jpreds in _batches(task, 5, "logits", kwargs.get("ignore_index")):
        p, t, jp, jt = torch.from_numpy(preds), torch.from_numpy(target), jnp.asarray(jpreds), jnp.asarray(target)
        want = getattr(jf, f"{task}_exact_match")(jp, jt, **width, **kwargs)
        assert_close(getattr(tf, f"{task}_exact_match")(p, t, **width, **kwargs), want, ATOL)
        assert_close(tf.exact_match(p, t, task=task, **width, **kwargs), want, ATOL)


def test_router_has_no_binary_task():
    for port_call, ref_call in (
        (lambda: ttm.ExactMatch(task="binary", device="cpu"), lambda: jtm.ExactMatch(task="binary")),
        (lambda: ttm.ExactMatch(task="multiclass", device="cpu"), lambda: jtm.ExactMatch(task="multiclass")),
        (
            lambda: tf.exact_match(torch.tensor([1]), torch.tensor([1]), task="binary"),
            lambda: jf.exact_match(jnp.asarray([1]), jnp.asarray([1]), task="binary"),
        ),
    ):
        with pytest.raises(ValueError) as port_err:
            port_call()
        with pytest.raises(ValueError) as ref_err:
            ref_call()
        assert str(port_err.value) == str(ref_err.value)
    metric = ttm.ExactMatch(task="multilabel", num_labels=L, threshold=0.3, multidim_average="samplewise", device="cpu")
    assert isinstance(metric, tc.MultilabelExactMatch) and metric.threshold == 0.3 and metric.correct == []


@pytest.mark.parametrize("task", ["multiclass", "multilabel"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_state_carried_from_jax(task, multidim_average):
    """Global ``correct`` / ``total`` counts, and samplewise ``correct`` lists with the
    last ``total``, carry from the JAX package and compute the same value."""
    make_port, make_ref = _pair(task, multidim_average=multidim_average, ignore_index=-1)
    batches = _batches(task, 6, "logits", -1)
    ref = make_ref()
    ref.persistent(True)
    for _, target, jpreds in batches[:2]:
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
    port = make_port()
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert_states(port, ref)
    for preds, target, jpreds in batches[2:]:
        ref.update(jnp.asarray(jpreds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), ATOL)
