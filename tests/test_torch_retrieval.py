"""The retrieval domain: the port (on the CPU) against the JAX package.

The ten retrieval classes at the three protocol levels of
``tests/differential/harness.py`` (``torch_parity.three_levels_args``), and the nine
functionals per query, on seeded epochs of 5 or 12 queries of 1-30 documents with
non-contiguous query ids, shuffled and split into ragged batches of 24 / 17 / 9 rows
(a query spans batches). Scores are rounded to 0.1, so ties are common; some epochs
hold NaN scores, queries with no positive (or, for fall-out, no negative) target,
``ignore_index`` rows and graded relevance 0-3 (nDCG). Every ``empty_target_action``
(``"error"`` raising in both packages), ``top_k``, ``adaptive_k`` and ``max_k``. The
deprecated root aliases warn at construction and the domain imports do not. Under the
engine every class falls back on every update (its list states), as in the JAX
engine. A JAX ``RetrievalMAP``'s ``None`` lists carried in with
``interop.state_from_jax`` finish their stream in the port, and a 2-rank gloo sync of
``PearsonCorrCoef`` and ``RetrievalMAP`` equals the JAX ``merge_state`` fold.

Tolerances: the packed ``(preds, target, valid)`` matrices are bit-equal to the JAX
package's (NaN and the ``-inf`` pads included), and so are the MRR's first-hit indices
and the functional argsort. The JAX side runs in 32-bit mode, the port's dtypes; the
per-query scores are float32 ratios of the same counts, and the averages over queries
are float32 sums taken in another order: values within relative 1e-6.
"""

from __future__ import annotations

import doctest
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jF
import torchmetrics_tpu.regression as jr
import torchmetrics_tpu.retrieval as jrt
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional as tF
import torchmetrics_tpu_torch.retrieval as trt
from tests.test_torch_sync_guard import run_two_ranks
from tests.torch_parity import assert_close, assert_states, engine_split, three_levels_args
from torchmetrics_tpu_torch.interop import state_from_jax

SIZES = (24, 17, 9)
IGNORE = -1
RTOL = 1e-6
# documents per query: one query of 1, one of 30 (seed 0); twelve queries (seed 1)
DOC_COUNTS = {0: (1, 30, 6, 4, 9), 1: (3, 5, 1, 8, 4, 6, 2, 7, 3, 5, 4, 2)}


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _epoch(seed: int, kind: str = "binary"):
    """Flat ``(preds, target, indexes)`` of one epoch, rows shuffled: query ids 7, 10,
    13, ...; the second query has no positive, the third no negative; ~10 % of the
    scores NaN. Every kind of one seed has the same rows, scores and queries (so the
    same matrix shapes: the JAX side compiles each shape once), only other targets."""
    rng = np.random.default_rng(seed)
    counts = DOC_COUNTS[seed % 2]
    indexes = np.repeat(7 + 3 * np.arange(len(counts)), counts).astype(np.int64)
    preds = np.round(rng.random(indexes.size), 1).astype(np.float32)
    preds[rng.random(indexes.size) < 0.1] = np.nan
    binary, graded = (rng.random(indexes.size) < 0.35).astype(np.int64), rng.integers(0, 4, indexes.size)
    target = graded if kind == "graded" else binary
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    target[starts[1]:starts[1] + counts[1]] = 0
    target[starts[2]:starts[2] + counts[2]] = 1
    ignored = rng.random(indexes.size) < 0.15
    if kind == "ignore":
        target[ignored] = IGNORE
    order = rng.permutation(indexes.size)
    return preds[order], target[order], indexes[order]


def _non_empty(preds, target, indexes):
    """The rows of the queries that have a positive and a negative target."""
    keep = np.ones(indexes.size, dtype=bool)
    for q in np.unique(indexes):
        rows = indexes == q
        if target[rows].min() == target[rows].max():
            keep &= ~rows
    return preds[keep], target[keep], indexes[keep]


def _batches(seed: int, kind: str = "binary") -> list:
    preds, target, indexes = _epoch(seed, kind)
    cuts = np.cumsum((0,) + SIZES)
    return [(preds[a:b], target[a:b], indexes[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]


# (class name, kwargs, data kind)
CASES = [
    ("RetrievalMAP", {"top_k": 3}, "binary"),
    ("RetrievalMRR", {}, "binary"),
    ("RetrievalPrecision", {"top_k": 4, "adaptive_k": True, "empty_target_action": "skip"}, "binary"),
    ("RetrievalRecall", {"top_k": 3}, "binary"),
    ("RetrievalFallOut", {"top_k": 3}, "binary"),
    ("RetrievalHitRate", {"top_k": 2}, "binary"),
    ("RetrievalRPrecision", {}, "binary"),
    ("RetrievalNormalizedDCG", {"top_k": 3}, "graded"),
    ("RetrievalPrecisionRecallCurve", {"max_k": 40, "adaptive_k": True, "empty_target_action": "skip"}, "binary"),
    ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.3, "max_k": 5}, "binary"),
]
_IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items())}-{kind}" for name, kw, kind in CASES]


@pytest.mark.parametrize("name, kwargs, kind", CASES, ids=_IDS)
def test_modular(name, kwargs, kind):
    batches = [(b, b) for b in _batches(0, kind)]
    three_levels_args(
        lambda: getattr(trt, name)(**kwargs, device="cpu"), lambda: getattr(jrt, name)(**kwargs), batches, 0.0, RTOL
    )


# (functional name, kwargs, graded)
FUNCTIONALS = [
    ("retrieval_average_precision", {}, False),
    ("retrieval_average_precision", {"top_k": 3}, False),
    ("retrieval_fall_out", {"top_k": 3}, False),
    ("retrieval_hit_rate", {"top_k": 2}, False),
    ("retrieval_normalized_dcg", {"top_k": 3}, True),
    ("retrieval_normalized_dcg", {}, True),
    ("retrieval_precision", {"top_k": 3}, False),
    ("retrieval_precision", {"top_k": 40, "adaptive_k": True}, False),
    ("retrieval_precision_recall_curve", {"max_k": 4}, False),
    ("retrieval_precision_recall_curve", {"max_k": 40, "adaptive_k": True}, False),
    ("retrieval_r_precision", {}, False),
    ("retrieval_recall", {"top_k": 3}, False),
    ("retrieval_reciprocal_rank", {}, False),
]


@pytest.mark.parametrize("fn, kwargs, graded", FUNCTIONALS, ids=[f"{f}-{k}" for f, k, _ in FUNCTIONALS])
def test_functional(fn, kwargs, graded):
    """Per query of the seed-0 epoch with 1 and 30 documents, NaN scores included."""
    preds, target, indexes = _epoch(0, "graded" if graded else "binary")
    for q in (7, 10):
        p, t = preds[indexes == q], target[indexes == q]
        assert_close(
            getattr(tF, fn)(torch.from_numpy(p), torch.from_numpy(t), **kwargs),
            getattr(jF, fn)(jnp.asarray(p), jnp.asarray(t), **kwargs), 0.0, RTOL, f"{fn} query {q}",
        )


@pytest.mark.parametrize("seed, kind", [(0, "binary"), (1, "binary"), (1, "graded")])
def test_pack_is_bit_equal(seed, kind):
    """The dense matrices of the port's device-side pack against the JAX package's numpy
    pack: ``np.lexsort`` order (ties in input order, NaN last), ``-inf`` / 0 / False pads."""
    from torchmetrics_tpu.retrieval.base import _pack_query_groups as jax_pack
    from torchmetrics_tpu_torch.retrieval.base import _pack_query_groups

    preds, target, indexes = _epoch(seed, kind)
    got = _pack_query_groups(
        torch.from_numpy(indexes).to(torch.int32), torch.from_numpy(preds), torch.from_numpy(target).to(torch.int32)
    )
    want = jax_pack(indexes.astype(np.int32), preds, target.astype(np.int32))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_argsort_and_first_hit_are_bit_equal():
    """The functional argsort (``jnp.argsort(-preds)``: ties in input order, NaN last,
    ``-0.0`` tied with ``0.0``) and the MRR's first hit (``jnp.argmax(rel > 0)``)."""
    from torchmetrics_tpu_torch.retrieval.reciprocal_rank import _first_hit
    from torchmetrics_tpu_torch.utilities.data import _argsort_descending

    x = np.array([0.3, np.nan, 0.3, -0.0, 1.0, 0.0, np.nan, -np.inf, 0.3, np.inf], dtype=np.float32)
    np.testing.assert_array_equal(_argsort_descending(torch.from_numpy(x)).numpy(), np.asarray(jnp.argsort(-jnp.asarray(x))))
    rel = np.array([[0, 0, 1, 1], [0, 0, 0, 0], [2, 0, 0, 3], [0, 0, 0, 1]], dtype=np.float32)
    np.testing.assert_array_equal(_first_hit(torch.from_numpy(rel)).numpy(), np.asarray(jnp.argmax(jnp.asarray(rel) > 0, axis=-1)))


@pytest.mark.parametrize(
    "name, kwargs, action",
    [("RetrievalMAP", {}, a) for a in ("error", "skip", "neg", "pos")]
    + [("RetrievalFallOut", {}, a) for a in ("error", "neg")]
    + [("RetrievalPrecisionRecallCurve", {"max_k": 5}, a) for a in ("error", "pos")],
)
def test_empty_target_actions(name, kwargs, action):
    """Each action on an epoch with empty queries; ``"error"`` raises in both packages,
    and computes on the epoch without them."""
    preds, target, indexes = _epoch(0)
    port = getattr(trt, name)(empty_target_action=action, **kwargs, device="cpu")
    ref = getattr(jrt, name)(empty_target_action=action, **kwargs)
    port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    if action == "error":
        with pytest.raises(ValueError, match="no (positive|negative) target"):
            port.compute()
        with pytest.raises(ValueError, match="no (positive|negative) target"):
            ref.compute()
        preds, target, indexes = _non_empty(preds, target, indexes)
        port = getattr(trt, name)(empty_target_action=action, **kwargs, device="cpu")
        ref = getattr(jrt, name)(empty_target_action=action, **kwargs)
        port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
        ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    assert_close(port.compute(), ref.compute(), 0.0, RTOL, action)


def test_ignore_index_rows_are_dropped():
    """``ignore_index`` rows leave the states in both packages (a boolean filter that
    changes the shape), with ``skip`` over the queries left empty."""
    preds, target, indexes = _epoch(0, "ignore")
    port = trt.RetrievalMAP(empty_target_action="skip", ignore_index=IGNORE, device="cpu")
    ref = jrt.RetrievalMAP(empty_target_action="skip", ignore_index=IGNORE)
    port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    assert port.preds[0].numel() == int((target != IGNORE).sum()) < target.size
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), 0.0, RTOL)


def test_compute_reads_the_host_once(monkeypatch):
    """Each class's ``compute`` reads the host once, for the matrices' shape (recall at
    fixed precision once more, for its pick), counted as ``.tolist()`` calls and scalar
    reads; an update reads it once, for the binary check (nDCG, graded, not at all)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                reads.append(func)
            return func(*args, **(kwargs or {}))

    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: reads.append("tolist") or tolist(self))
    preds, target, indexes = (torch.from_numpy(x) for x in _epoch(0))
    for name in [n for n in trt.__all__ if n != "RetrievalMetric"]:
        m = getattr(trt, name)(**({"min_precision": 0.3} if name == "RetrievalRecallAtFixedPrecision" else {}), device="cpu")
        reads.clear()
        with Reads():
            m.update(preds, target, indexes)
        assert len(reads) == (0 if name == "RetrievalNormalizedDCG" else 1), (name, "update", reads)
        reads.clear()
        with Reads():
            m.compute()
        assert len(reads) == (2 if name == "RetrievalRecallAtFixedPrecision" else 1), (name, "compute", reads)


def test_argument_and_input_errors():
    with pytest.raises(ValueError, match="empty_target_action"):
        trt.RetrievalMAP(empty_target_action="drop", device="cpu")
    with pytest.raises(ValueError, match="ignore_index"):
        trt.RetrievalMAP(ignore_index=0.5, device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        trt.RetrievalRecall(top_k=0, device="cpu")
    with pytest.raises(ValueError, match="adaptive_k"):
        trt.RetrievalPrecision(adaptive_k=1, device="cpu")
    with pytest.raises(ValueError, match="min_precision"):
        trt.RetrievalRecallAtFixedPrecision(min_precision=2.0, device="cpu")
    m = trt.RetrievalMAP(device="cpu")
    with pytest.raises(ValueError, match="cannot be None"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.long), None)
    with pytest.raises(ValueError, match="same shape"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.long), torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="long integers"):
        m.update(torch.rand(3), torch.ones(3, dtype=torch.long), torch.zeros(3))
    with pytest.raises(ValueError, match="tensor of floats"):
        m.update(torch.ones(3, dtype=torch.long), torch.ones(3, dtype=torch.long), torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="booleans or integers"):
        m.update(torch.rand(3), torch.rand(3), torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="binary"):
        m.update(torch.rand(3), torch.tensor([0, 2, 1]), torch.zeros(3, dtype=torch.long))
    with pytest.raises(ValueError, match="non-empty"):
        tF.retrieval_recall(torch.zeros(0), torch.zeros(0, dtype=torch.long))
    with pytest.raises(ValueError, match="top_k"):
        tF.retrieval_average_precision(torch.rand(3), torch.ones(3, dtype=torch.long), top_k=-1)


def test_metric_hook_of_a_user_subclass():
    """A subclass that only defines the per-query ``_metric`` runs through the row loop,
    with int32 relevance, as in the JAX package."""

    class TopHit(trt.RetrievalMetric):
        def _metric(self, preds, target):
            assert target.dtype == torch.int32
            return target[0].to(torch.float32)

    class JaxTopHit(jrt.RetrievalMetric):
        def _metric(self, preds, target):
            return target[0].astype(jnp.float32)

    preds, target, indexes = _epoch(0)
    port, ref = TopHit(device="cpu"), JaxTopHit()
    port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(indexes))
    ref.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(indexes))
    assert_close(port.compute(), ref.compute(), 0.0, RTOL)


def test_root_aliases_warn_and_domain_imports_do_not():
    for name in trt.__all__:
        if name == "RetrievalMetric":
            continue
        with pytest.warns(DeprecationWarning, match=f"torchmetrics_tpu_torch.retrieval.{name}"):
            alias = getattr(ttm, name)(device="cpu")
        assert isinstance(alias, getattr(trt, name))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            getattr(trt, name)(device="cpu")
    assert ttm.RetrievalMetric is trt.RetrievalMetric
    assert set(jrt.__all__) == set(trt.__all__)


@pytest.mark.parametrize("name", [n for n in trt.__all__ if n != "RetrievalMetric"])
def test_engine_falls_back_on_every_update(name):
    """The list states keep every retrieval update out of a graph, in both engines."""
    kwargs = {"min_precision": 0.3} if name == "RetrievalRecallAtFixedPrecision" else {}
    st = engine_split(
        lambda: getattr(trt, name)(**kwargs, device="cpu"), lambda: getattr(jrt, name)(**kwargs),
        [(b, b) for b in _batches(1, "graded" if name == "RetrievalNormalizedDCG" else "binary")],
    )
    assert (st.dispatches, st.eager_fallbacks) == (0, len(SIZES)) and dict(st.fallback_reasons) == {"list-state": 3}


def test_none_lists_carried_from_jax_finish_their_stream():
    batches = _batches(0)
    ref = jrt.RetrievalMAP(top_k=3)
    for p, t, i in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(i))
    ref.persistent(True)
    port = trt.RetrievalMAP(top_k=3, device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    p, t, i = batches[2]
    port.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(i))
    ref.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(i))
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), 0.0, RTOL)


_TWO_RANKS = """
def batches(rank):
    import numpy as np

    rng = np.random.default_rng(200 + rank)
    out = []
    for _ in range(3):  # equal counts and per-position shapes on both ranks: None-reduced lists
        x = rng.normal(0.0, 1.0, 16).astype(np.float32)
        out.append((x, (0.5 * x + rng.normal(0.0, 1.0, 16)).astype(np.float32),
                    np.round(rng.random(16), 1).astype(np.float32), rng.integers(0, 2, 16), rng.integers(0, 5, 16)))
    return out

def run(rank):  # imports here: the launcher process never needs torch
    import torch
    from torchmetrics_tpu_torch.regression import PearsonCorrCoef
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    pearson, rmap = PearsonCorrCoef(device="cpu"), RetrievalMAP(device="cpu")
    for x, y, p, t, i in batches(rank):
        pearson.update(torch.from_numpy(x), torch.from_numpy(y))
        rmap.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(i + 5 * rank))
    values = [float(pearson.compute()), float(rmap.compute())]
    return {"values": values, "batches": [[a.tolist() for a in b] for b in batches(rank)],
            "packed": [m._epoch.stats.packed_syncs if m._epoch else 0 for m in (pearson, rmap)],
            "local_shape": list(pearson.mean_x.shape)}
"""


def test_pearson_and_retrieval_sync_over_two_gloo_ranks(tmp_path):
    """Each rank's ``compute`` syncs the stacked Pearson moments and the ``None`` lists
    of ``RetrievalMAP`` (queries 0-4 on rank 0, 5-9 on rank 1) on the packed route and
    equals the JAX ``merge_state`` fold of the two ranks' streams; the local Pearson
    moments are back to one row after."""
    results = run_two_ranks(tmp_path, _TWO_RANKS)
    refs = []
    for res in results:
        pearson, rmap = jr.PearsonCorrCoef(), jrt.RetrievalMAP()
        for x, y, p, t, i in res["batches"]:
            pearson.update(jnp.asarray(x, dtype=jnp.float32), jnp.asarray(y, dtype=jnp.float32))
            rmap.update(jnp.asarray(p, dtype=jnp.float32), jnp.asarray(t), jnp.asarray(i) + 5 * len(refs))
        refs.append((pearson, rmap))
    for ra, rb in zip(*refs):
        ra.merge_state(rb)
    want = [float(m.compute()) for m in refs[0]]
    for rank, res in enumerate(results):
        assert res["ok"], res
        assert res["local_shape"] == [1] and res["packed"] == [1, 1], res
        np.testing.assert_allclose(res["values"], want, rtol=1e-5, atol=1e-6, err_msg=f"rank {rank}")


_RETRIEVAL_MODULES = ("average_precision", "fall_out", "hit_rate", "ndcg", "precision", "precision_recall_curve",
                      "r_precision", "recall", "reciprocal_rank")


@pytest.mark.parametrize(
    "module", [f"torchmetrics_tpu_torch.{pkg}retrieval.{m}" for pkg in ("", "functional.") for m in _RETRIEVAL_MODULES]
)
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
