"""Specificity and Hamming distance: the port (on the CPU) against the JAX package.

Both families are reduces of the stat-scores counters, so they ride the paths the
stat-scores tests already hold: kernel K1's plain version for multiclass logits at
``top_k=1`` with global accumulation, the staged format and update otherwise. Every
task takes the same seeded numpy batches as the JAX package at the three protocol
levels (``torch_parity.three_levels``: per-batch ``forward``, a two-replica fold, the
epoch ``compute``), over ragged batches, with and without ``ignore_index``, for every
``average``, ``multidim_average`` and ``top_k`` the JAX module takes, with logits,
probabilities and labels. The functional twins and the state carried from the JAX
package are held too.

Tolerances: counts exact; ratios 1e-6 (absolute, and relative 1e-6 for float32 means
of per-class ratios, which sum in another order).
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
from torchmetrics_tpu_torch.interop import state_from_jax

RATIO_ATOL = RATIO_RTOL = 1e-6
C, L = 5, 4
SIZES = (48, 37, 64, 21)  # ragged batches
AVERAGES = ["micro", "macro", "weighted", "none"]
FAMILIES = ["Specificity", "HammingDistance"]


def _batches(task: str, seed: int, kind: str = "logits", ignore_index=None, extra: int = 0):
    """``(port preds, target, JAX preds)``; ``kind``: logits, probs, labels or tied
    (multiclass scores rounded to 0.1, the top-k tie case)."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        if task == "binary":
            shape = (n, extra) if extra else (n,)
            tshape, width = shape, 2
        elif task == "multiclass":
            shape = (n, C, extra) if extra else (n, C)
            tshape, width = ((n, extra) if extra else (n,)), C
        else:
            shape = (n, L, extra) if extra else (n, L)
            tshape, width = shape, 2
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        if kind == "labels":
            preds = rng.integers(0, width, tshape)
        elif kind == "probs" and task == "multiclass":
            e = np.exp(logits - logits.max(1, keepdims=True))
            preds = (e / e.sum(1, keepdims=True)).astype(np.float32)
        elif kind == "probs":
            preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
        elif kind == "tied":
            e = np.exp(logits - logits.max(1, keepdims=True))
            preds = np.round(e / e.sum(1, keepdims=True), 1).astype(np.float32)
        else:
            preds = logits
        target = rng.integers(0, width, tshape)
        if ignore_index is not None:
            target[rng.random(tshape) < 0.15] = ignore_index
        out.append((preds, target, jax_scores(preds) if task != "multiclass" else preds))
    return out


def _pair(name: str, task: str, **kwargs):
    prefix = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task]
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    return (
        lambda: getattr(tc, prefix + name)(**width, **kwargs, device="cpu"),
        lambda: getattr(jc, prefix + name)(**width, **kwargs),
    )


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_binary(family, kind, ignore_index, multidim_average):
    extra = 6 if multidim_average == "samplewise" else 0
    make_port, make_ref = _pair(family, "binary", ignore_index=ignore_index, multidim_average=multidim_average)
    three_levels(make_port, make_ref, _batches("binary", 1, kind, ignore_index, extra), RATIO_ATOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_global(family, average, kind, ignore_index):
    """2-D logits and probabilities take K1's plain version; labels the staged stages."""
    make_port, make_ref = _pair(family, "multiclass", average=average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multiclass", 2, kind, ignore_index), RATIO_ATOL, RATIO_RTOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("kind", ["logits", "tied"])
def test_multiclass_top_k(family, average, top_k, kind):
    """``top_k > 1`` goes through ``select_topk``: tied scores take the lower class
    first, as ``jax.lax.top_k`` does."""
    make_port, make_ref = _pair(family, "multiclass", average=average, top_k=top_k, ignore_index=-1)
    three_levels(make_port, make_ref, _batches("multiclass", 3, kind, -1), RATIO_ATOL, RATIO_RTOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_samplewise(family, average, ignore_index):
    make_port, make_ref = _pair(
        family, "multiclass", average=average, multidim_average="samplewise", ignore_index=ignore_index
    )
    batches = _batches("multiclass", 4, "logits", ignore_index, extra=5)
    three_levels(make_port, make_ref, batches, RATIO_ATOL, RATIO_RTOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_global(family, average, kind, ignore_index):
    make_port, make_ref = _pair(family, "multilabel", average=average, ignore_index=ignore_index)
    three_levels(make_port, make_ref, _batches("multilabel", 5, kind, ignore_index), RATIO_ATOL, RATIO_RTOL)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("average", AVERAGES)
def test_multilabel_samplewise(family, average):
    make_port, make_ref = _pair(
        family, "multilabel", average=average, multidim_average="samplewise", ignore_index=-1
    )
    three_levels(make_port, make_ref, _batches("multilabel", 6, "logits", -1, extra=3), RATIO_ATOL, RATIO_RTOL)


@pytest.mark.parametrize("threshold", [0.3, 0.7])
@pytest.mark.parametrize("family", FAMILIES)
def test_thresholds(family, threshold):
    for task in ("binary", "multilabel"):
        kw = dict(threshold=threshold, ignore_index=-1) if task == "binary" else dict(
            threshold=threshold, average="macro", ignore_index=-1
        )
        make_port, make_ref = _pair(family, task, **kw)
        three_levels(make_port, make_ref, _batches(task, 7, "probs", -1), RATIO_ATOL, RATIO_RTOL)


_FUNCTIONAL = [
    ("binary", {}),
    ("binary", dict(multidim_average="samplewise", ignore_index=-1)),
    ("multiclass", dict(average="macro")),
    ("multiclass", dict(average="weighted", top_k=2, ignore_index=-1)),
    ("multiclass", dict(average="micro", ignore_index=-1)),
    ("multilabel", dict(average="none", ignore_index=-1)),
    ("multilabel", dict(average="micro", threshold=0.3)),
]


@pytest.mark.parametrize("family", ["specificity", "hamming_distance"])
@pytest.mark.parametrize(("task", "kwargs"), _FUNCTIONAL)
def test_functional(family, task, kwargs):
    extra = 4 if kwargs.get("multidim_average") == "samplewise" else 0
    width = {"binary": {}, "multiclass": dict(num_classes=C), "multilabel": dict(num_labels=L)}[task]
    for preds, target, jpreds in _batches(task, 8, "logits", kwargs.get("ignore_index"), extra):
        got = getattr(tf, f"{task}_{family}")(torch.from_numpy(preds), torch.from_numpy(target), **width, **kwargs)
        want = getattr(jf, f"{task}_{family}")(jnp.asarray(jpreds), jnp.asarray(target), **width, **kwargs)
        assert_close(got, want, RATIO_ATOL, RATIO_RTOL, f"{family} {task}")
        routed = getattr(tf, family)(
            torch.from_numpy(preds), torch.from_numpy(target), task=task, **width,
            **{"average": "micro", **kwargs},
        )
        want = getattr(jf, family)(
            jnp.asarray(jpreds), jnp.asarray(target), task=task, **width, **{"average": "micro", **kwargs}
        )
        assert_close(routed, want, RATIO_ATOL, RATIO_RTOL, f"{family} router {task}")


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_state_carried_from_jax(family, task):
    """A JAX metric takes two batches, the port takes its state and the rest."""
    kwargs = {} if task == "binary" else dict(average="macro")
    make_port, make_ref = _pair(family, task, ignore_index=-1, **kwargs)
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
    assert port.update_count == ref.update_count == len(batches)
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), RATIO_ATOL, RATIO_RTOL)
