"""Regression's moment-merge and ``cat``-state half: the port (on the CPU) against the JAX package.

Pearson, concordance, KL divergence, cosine similarity, Spearman and Kendall, modular at
the three protocol levels of ``tests/differential/harness.py`` (``torch_parity``) on
ragged seeded batches of 24 / 17 / 9 rows, and functional. Edge cases: Pearson and
concordance at ``num_outputs=8``, Pearson merged three ways (the stacked
``dist_reduce_fx=None`` fold), every KL and cosine reduction, Kendall at every variant
and alternative and on all-tied columns, Spearman on NaN and on tied values. Under the
compiled engine Pearson, concordance and KL (``mean`` / ``sum``) replay and the ``cat``
states fall back, as in the JAX engine, with the engine state bit-equal to eager. A
merged JAX Pearson (stacked ``(2, num_outputs)`` moments) and a Spearman ``cat`` state
carried in with ``interop.state_from_jax`` finish their streams in the port.

Tolerances, stated per family:
- Pearson, concordance, KL and cosine run JAX in 32-bit mode, the port's dtypes. Each
  sum over a batch is added in another order by XLA and by PyTorch, so states and values
  are held to relative 1e-5 (``RTOL``; a correlation near 0 to absolute 1e-6), KL's
  per-row logs to the same.
- Spearman and Kendall run JAX under x64 (the test default), where its ranks and pair
  statistics are float64. The port counts pairs and ties in int64, held exactly equal
  to the JAX counts, computes in float64 and rounds once to float32: values within one
  float32 ulp (relative ``2**-23``) of the JAX float64 value.
"""

from __future__ import annotations

import doctest
import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.functional as jF
import torchmetrics_tpu.regression as jr
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional as tF
import torchmetrics_tpu_torch.regression as tr
from tests.torch_parity import assert_close, assert_states, engine_split, three_levels_args
from torchmetrics_tpu.functional.regression.kendall import _kendall_stats_1d as jax_kendall_stats
from torchmetrics_tpu_torch.functional.regression.kendall import _kendall_stats_1d
from torchmetrics_tpu_torch.interop import state_from_jax

SIZES = (24, 17, 9)
OUTPUTS = 8
RTOL = 1e-5
ATOL = 1e-6
RANK_RTOL = 2.0**-23


def _pair(rng, n: int, outputs: int, kind: str):
    shape = (n, outputs) if outputs else (n,)
    if kind == "dist":  # rows of positive weights (KL), normalized by the metric
        return rng.random(shape).astype(np.float32) + 0.05, rng.random(shape).astype(np.float32) + 0.05
    if kind == "logdist":
        p = np.log(rng.dirichlet(np.ones(shape[-1]), n)).astype(np.float32)
        return p, np.log(rng.dirichlet(np.ones(shape[-1]), n)).astype(np.float32)
    if kind == "ties":  # scores rounded to 0.1: many ties
        return np.round(rng.random(shape), 1).astype(np.float32), np.round(rng.random(shape), 1).astype(np.float32)
    x = rng.normal(2.0, 1.0, shape).astype(np.float32)
    return x, (0.7 * x + rng.normal(0.0, 0.5, shape)).astype(np.float32)


def _batches(seed: int, outputs: int = 0, kind: str = "normal", sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [_pair(rng, n, outputs, kind) for n in sizes]


# (class name, kwargs, functional name or None, outputs, data kind, JAX x64)
CASES = [
    ("PearsonCorrCoef", {}, "pearson_corrcoef", 0, "normal", False),
    ("ConcordanceCorrCoef", {}, "concordance_corrcoef", 0, "normal", False),
    ("KLDivergence", {}, "kl_divergence", 4, "dist", False),
    ("KLDivergence", {"reduction": "none"}, "kl_divergence", 4, "dist", False),
    ("CosineSimilarity", {}, "cosine_similarity", 4, "normal", False),
    ("SpearmanCorrCoef", {}, "spearman_corrcoef", 0, "ties", True),
    # every variant and alternative, modular and functional: test_kendall_every_variant_and_alternative
    ("KendallRankCorrCoef", {"variant": "c", "t_test": True, "alternative": "less"}, None, 0, "ties", True),
]
# the other options functionally: eight outputs (also merged three ways and under the
# engine), the other reductions, a 2-D Spearman (modular in the state-carry test)
_FUNCTIONAL = [c for c in CASES if c[2] is not None] + [
    ("PearsonCorrCoef", {}, "pearson_corrcoef", OUTPUTS, "normal", False),
    ("ConcordanceCorrCoef", {}, "concordance_corrcoef", OUTPUTS, "normal", False),
    ("KLDivergence", {"reduction": None}, "kl_divergence", 4, "dist", False),
    ("KLDivergence", {"log_prob": True, "reduction": "sum"}, "kl_divergence", 4, "logdist", False),
    ("CosineSimilarity", {"reduction": "mean"}, "cosine_similarity", 4, "normal", False),
    ("CosineSimilarity", {"reduction": "none"}, "cosine_similarity", 4, "normal", False),
    ("CosineSimilarity", {"reduction": None}, "cosine_similarity", 4, "normal", False),
    ("SpearmanCorrCoef", {}, "spearman_corrcoef", 3, "ties", True),
]
_IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for name, kw, *_ in CASES]


def _tols(x64: bool) -> dict:
    return {"atol": 0.0, "rtol": RANK_RTOL} if x64 else {"atol": ATOL, "rtol": RTOL}


@pytest.mark.parametrize("name, kwargs, fn, outputs, kind, x64", CASES, ids=_IDS)
def test_modular(name, kwargs, fn, outputs, kind, x64):
    with jax.enable_x64(x64):
        three_levels_args(
            lambda: getattr(tr, name)(**kwargs, device="cpu"),
            lambda: getattr(jr, name)(**kwargs),
            [(b, b) for b in _batches(0, outputs, kind)],
            **_tols(x64), float_state_rtol=0.0 if x64 else RTOL, float_state_atol=0.0 if x64 else ATOL,
        )


@pytest.mark.parametrize(
    "name, kwargs, fn, outputs, kind, x64", _FUNCTIONAL, ids=[f"{c[0]}-{c[1]}-{c[3]}" for c in _FUNCTIONAL]
)
def test_functional(name, kwargs, fn, outputs, kind, x64):
    kw = {k: v for k, v in kwargs.items() if k != "num_outputs"}
    with jax.enable_x64(x64):
        for preds, target in _batches(0, outputs, kind):
            assert_close(
                getattr(tF, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
                getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target), **kw), msg=fn, **_tols(x64),
            )


def _update_all(metric, batches, port: bool):
    for p, t in batches:
        if port:
            metric.update(torch.from_numpy(p), torch.from_numpy(t))
        else:
            metric.update(jnp.asarray(p), jnp.asarray(t))
    return metric


@pytest.mark.parametrize("outputs", [0, OUTPUTS])
def test_pearson_merged_three_ways(outputs):
    """Three replicas folded: the ``dist_reduce_fx=None`` moments stack to ``(3,
    num_outputs)`` in both packages, and ``compute`` merges the rows pairwise."""
    kw = {"num_outputs": outputs} if outputs else {}
    batches = _batches(2, outputs, sizes=SIZES * 2)
    with jax.enable_x64(False):
        ports = [_update_all(tr.PearsonCorrCoef(**kw, device="cpu"), batches[i::3], True) for i in range(3)]
        refs = [_update_all(jr.PearsonCorrCoef(**kw), batches[i::3], False) for i in range(3)]
        ports[0].merge_state(ports[1])
        ports[0].merge_state(ports[2])
        refs[0].merge_state(refs[1])
        refs[0].merge_state(refs[2])
        assert tuple(ports[0].mean_x.shape) == np.asarray(refs[0].mean_x).shape == (3, max(outputs, 1))
        assert_states(ports[0], refs[0], ATOL, RTOL)
        assert_close(ports[0].compute(), refs[0].compute(), ATOL, RTOL, "merged")
        one = _update_all(jr.PearsonCorrCoef(**kw), batches, False)
        assert_close(ports[0].compute(), one.compute(), ATOL, RTOL, "merged against one instance")
        ccc, jccc = tr.ConcordanceCorrCoef(**kw, device="cpu"), jr.ConcordanceCorrCoef(**kw)
        for attr in jccc._defaults:  # the stacked moments, as a merge leaves them
            setattr(ccc, attr, getattr(ports[0], attr))
            setattr(jccc, attr, getattr(refs[0], attr))
        assert_close(ccc.compute(), jccc.compute(), ATOL, RTOL, "merged concordance")


def test_kendall_pair_counts_are_exact(monkeypatch):
    """The int64 pair and tie counts equal the JAX float64 ones (the port counts each pair
    from both its rows, so its pair and Σ(t−1) counts are halved), NaN rows included;
    the float64 Σ 1/t within 1e-12. Blocks of 3 rows: the last one ragged."""
    from torchmetrics_tpu_torch.functional.regression import kendall

    monkeypatch.setattr(kendall, "_PAIR_ELEMENTS", 3 * 37)
    rng = np.random.default_rng(3)
    for n in (2, 37):
        x = np.round(rng.random(n), 1).astype(np.float32)
        y = np.round(rng.random(n), 2).astype(np.float32)
        if n > 2:
            x[2] = np.nan
        got = [float(v) for v in _kendall_stats_1d(torch.from_numpy(x), torch.from_numpy(y))]
        got[:4] = [v / 2 for v in got[:4]]
        want = [float(v) for v in jax_kendall_stats(jnp.asarray(x), jnp.asarray(y))]
        assert got[:8] == want[:8], (n, got, want)
        np.testing.assert_allclose(got[8:], want[8:], rtol=1e-12)  # Σ 1/t: float64 sums in two orders


def _kendall_data():
    rng = np.random.default_rng(9)
    ties = np.round(rng.random((50, 2)), 1).astype(np.float32), np.round(rng.random((50, 2)), 2).astype(np.float32)
    # a constant column (no pair concordant or discordant) beside a tied one, and the mirror
    tied = (
        np.stack([np.full(12, 0.5), np.round(np.linspace(0, 1, 12), 1)], 1).astype(np.float32),
        np.stack([np.round(np.linspace(1, 0, 12), 1), np.full(12, 2.0)], 1).astype(np.float32),
    )
    return {"ties": ties, "all_tied": tied}


@pytest.mark.parametrize("data", ["ties", "all_tied"])
def test_kendall_every_variant_and_alternative(data):
    """``kendall_rank_corrcoef`` at each variant, without the test and with each
    alternative, against the JAX formulas on the JAX pair statistics (computed once per
    data: its pair scan compiles per call); the JAX functional itself at its defaults."""
    from torchmetrics_tpu.functional.regression import kendall as jk

    preds, target = _kendall_data()[data]
    stats = jax.vmap(jk._kendall_stats_1d, in_axes=1, out_axes=0)(jnp.asarray(preds), jnp.asarray(target))
    n = jnp.asarray(float(preds.shape[0]))
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    for variant in ("a", "b", "c"):
        v = jk._MetricVariant.from_str(variant)
        tau = jnp.clip(jk._calculate_tau(stats, n, v), -1.0, 1.0)
        assert_close(tF.kendall_rank_corrcoef(tp, tt, variant), tau, 0.0, RANK_RTOL, f"{data} {variant}")
        for alternative in ("two-sided", "less", "greater"):
            p_value = jk._calculate_p_value(stats, n, v, jk._TestAlternative.from_str(alternative))
            got = tF.kendall_rank_corrcoef(tp, tt, variant, t_test=True, alternative=alternative)
            assert_close(got, (tau, p_value), 0.0, RANK_RTOL, f"{data} {variant} {alternative}")
            m = tr.KendallRankCorrCoef(variant, True, alternative, num_outputs=2, device="cpu")
            m.update(tp, tt)
            assert_close(m.compute(), (tau, p_value), 0.0, RANK_RTOL, f"modular {data} {variant} {alternative}")
    assert_close(
        tF.kendall_rank_corrcoef(tp, tt), jF.kendall_rank_corrcoef(jnp.asarray(preds), jnp.asarray(target)), 0.0,
        RANK_RTOL, f"{data} defaults",
    )


def test_spearman_on_nan_and_ties():
    """NaN ranks last with every NaN tied, ``-0.0`` ties with ``0.0``, tied values share
    their mean rank: the JAX package's sort order, which ``torch.searchsorted`` over a
    float tensor holding NaN does not give."""
    from torchmetrics_tpu.functional.regression.spearman import _rank_data as jax_rank
    from torchmetrics_tpu_torch.functional.regression.spearman import _rank_data

    x = np.array([3.0, np.nan, 1.0, 3.0, -0.0, 0.0, np.inf, np.nan, -np.inf, 1.0], dtype=np.float32)
    y = np.array([0.1, 0.2, 0.2, 0.4, 0.5, np.nan, 0.7, 0.2, 0.9, 1.0], dtype=np.float32)
    np.testing.assert_array_equal(_rank_data(torch.from_numpy(x)).numpy(), np.asarray(jax_rank(jnp.asarray(x))))
    both = np.stack([x, y], 1)
    want = np.stack([np.asarray(jax_rank(jnp.asarray(both[:, i]))) for i in range(2)], 1)
    np.testing.assert_array_equal(_rank_data(torch.from_numpy(both)).numpy(), want)
    finite = np.round(np.random.default_rng(4).random((40, 2)), 1).astype(np.float32)
    for data in (finite, np.where(np.arange(40)[:, None] % 7 == 0, np.nan, finite).astype(np.float32)):
        assert_close(
            tF.spearman_corrcoef(torch.from_numpy(data[:, 0]), torch.from_numpy(data[:, 1])),
            jF.spearman_corrcoef(jnp.asarray(data[:, 0]), jnp.asarray(data[:, 1])), 0.0, RANK_RTOL,
        )


def test_argument_errors():
    with pytest.raises(ValueError, match="num_outputs"):
        tr.PearsonCorrCoef(num_outputs=0, device="cpu")
    with pytest.raises(ValueError, match="num_outputs"):
        tr.SpearmanCorrCoef(num_outputs=-1, device="cpu")
    with pytest.raises(TypeError, match="log_prob"):
        tr.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tr.KLDivergence(reduction="max", device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tr.CosineSimilarity(reduction="max", device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        tF.cosine_similarity(torch.ones(2, 2), torch.ones(2, 2), reduction="max")
    with pytest.raises(ValueError, match="2D"):
        tF.kl_divergence(torch.ones(3), torch.ones(3))
    with pytest.raises(TypeError, match="floating point"):
        tF.spearman_corrcoef(torch.arange(4), torch.arange(4))
    with pytest.raises(ValueError, match="t_test"):
        tr.KendallRankCorrCoef(t_test=1, device="cpu")
    with pytest.raises(ValueError, match="alternative"):
        tF.kendall_rank_corrcoef(torch.ones(3), torch.ones(3), t_test=True, alternative=None)
    with pytest.raises(ValueError, match="Invalid variant"):
        tr.KendallRankCorrCoef(variant="d", device="cpu")
    with pytest.raises(ValueError, match="Invalid alternative"):
        tr.KendallRankCorrCoef(t_test=True, alternative="both", device="cpu")
    with pytest.raises(ValueError, match="num_outputs"):
        tr.PearsonCorrCoef(num_outputs=2, device="cpu").update(torch.ones(3, 3), torch.ones(3, 3))
    with pytest.raises(RuntimeError, match="same shape"):
        tF.pearson_corrcoef(torch.ones(3), torch.ones(4))


# ---------------------------------------------------------------- the engine

# every class; the moment tensors also at eight outputs, KL with its sum and its list
_ENGINE_CASES = CASES + [("PearsonCorrCoef", {"num_outputs": OUTPUTS}, None, OUTPUTS, "normal", False)]


@pytest.mark.parametrize("name, kwargs, fn, outputs, kind, x64", _ENGINE_CASES, ids=[*_IDS, "PearsonCorrCoef-8"])
def test_engine_split(name, kwargs, fn, outputs, kind, x64):
    """Pearson, concordance and KL ``mean`` / ``sum`` replay where the JAX engine compiles;
    the ``cat`` list states fall back on every update, as there."""
    st = engine_split(
        lambda: getattr(tr, name)(**kwargs, device="cpu"), lambda: getattr(jr, name)(**kwargs),
        [(b, b) for b in _batches(5, outputs, kind)],
    )
    lists = name in ("SpearmanCorrCoef", "KendallRankCorrCoef", "CosineSimilarity") or kwargs.get("reduction", "mean") in (
        "none", None
    )
    if lists:
        assert (st.dispatches, st.eager_fallbacks) == (0, len(SIZES)) and dict(st.fallback_reasons) == {"list-state": 3}
    else:
        assert (st.dispatches, st.eager_fallbacks) == (len(SIZES), 0), dict(st.fallback_reasons)


def test_collection_groups_pearson_with_concordance():
    """Concordance subclasses Pearson: equal states, one compute group, in both packages."""

    def members(pkg, **device):
        return {"pearson": pkg.PearsonCorrCoef(**device), "ccc": pkg.ConcordanceCorrCoef(**device)}

    with jax.enable_x64(False):
        port = ttm.MetricCollection(members(tr, device="cpu"))
        ref = jtm.MetricCollection(members(jr))
        for p, t in _batches(6):
            port.update(torch.from_numpy(p), torch.from_numpy(t))
            ref.update(jnp.asarray(p), jnp.asarray(t))
        groups = {frozenset(g) for g in port.compute_groups.values()}
        assert groups == {frozenset(g) for g in ref.compute_groups.values()} == {frozenset({"pearson", "ccc"})}
        assert_close(port.compute(), ref.compute(), ATOL, RTOL)


# ---------------------------------------------------------------- carried state


def test_merged_pearson_carried_from_jax_finishes_its_stream():
    """A JAX Pearson merged from two replicas (moments stacked ``(2, num_outputs)``) loads
    into the port, which folds a third replica and computes the JAX value."""
    batches = _batches(7, OUTPUTS)
    with jax.enable_x64(False):
        ra, rb, rc = (_update_all(jr.PearsonCorrCoef(num_outputs=OUTPUTS), [b], False) for b in batches)
        ra.merge_state(rb)
        ra.persistent(True)
        port = tr.PearsonCorrCoef(num_outputs=OUTPUTS, device="cpu")
        port.load_state_dict(state_from_jax(ra.state_dict(), "cpu"))
        assert tuple(port.mean_x.shape) == (2, OUTPUTS)
        assert_close(port.compute(), ra.compute(), ATOL, RTOL, "carried")
        port.merge_state(_update_all(tr.PearsonCorrCoef(num_outputs=OUTPUTS, device="cpu"), [batches[2]], True))
        ra.merge_state(rc)
        assert_states(port, ra, ATOL, RTOL)
        assert_close(port.compute(), ra.compute(), ATOL, RTOL, "finished")


def test_spearman_cat_state_carried_from_jax_finishes_its_stream():
    batches = _batches(8, 3, "ties")
    ref = _update_all(jr.SpearmanCorrCoef(num_outputs=3), batches[:2], False)
    ref.persistent(True)
    port = tr.SpearmanCorrCoef(num_outputs=3, device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    _update_all(port, batches[2:], True)
    _update_all(ref, batches[2:], False)
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), 0.0, RANK_RTOL)


@pytest.mark.parametrize(
    "module",
    [f"torchmetrics_tpu_torch.{pkg}regression.{m}" for pkg in ("", "functional.")
     for m in ("pearson", "concordance", "kl_divergence", "cosine_similarity", "spearman", "kendall")],
)
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed


def test_fused_collection_graph_carries_the_moments():
    """Pearson and concordance (one group) beside an MSE: under the engine the group
    owners replay as one fused step from the second update (the first discovers the
    groups), and every state is bit-equal to the eager collection's."""
    from torchmetrics_tpu_torch.engine import engine_context

    def members():
        return {"pearson": tr.PearsonCorrCoef(device="cpu"), "ccc": tr.ConcordanceCorrCoef(device="cpu"),
                "mse": tr.MeanSquaredError(device="cpu")}

    batches = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in _batches(10, sizes=(24, 24, 24, 24))]
    runs = {}
    for on in (True, False):
        with engine_context(on):
            mc = ttm.MetricCollection(members())
            for b in batches:
                mc.update(*b)
            runs[on] = mc
    st = runs[True]._fused_engine.stats
    assert (st.dispatches, st.eager_fallbacks) == (len(batches) - 1, 0), st.as_dict()
    for name in ("pearson", "ccc", "mse"):
        assert_states(runs[True][name], runs[False][name])
    assert_close(runs[True].compute(), runs[False].compute(), 0.0, 0.0)
