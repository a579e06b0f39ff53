"""The nominal association metrics: the port (on the CPU) against the JAX package.

Cramér's V, Tschuprow's T, Pearson's contingency coefficient, Theil's U and Fleiss'
kappa, modular at the three protocol levels of ``tests/differential/harness.py``
(``torch_parity``) on ragged seeded batches of 40 / 33 / 27 rows, one or two kwarg sets
per class: bias correction on and off, ``nan_strategy`` ``"replace"`` and ``"drop"``,
1-D codes and 2-D logits, Fleiss in counts and probs mode. The other options run
functionally and through the ``*_matrix`` functionals, on arbitrary category values
(floats, sparse integers) that the functionals densify. Under the compiled engine the
four table metrics replay on both NaN strategies; the JAX engine falls back on
``"drop"`` (its boolean index), which the port masks instead, with equal values.

Tolerances: tables and Fleiss' count rows exact; the float64 statistics, rounded once to
float32 on both sides, within relative 1e-6; Fleiss' float32 compute within 1e-5.
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

import torchmetrics_tpu as jtm
import torchmetrics_tpu.functional as jF
import torchmetrics_tpu.nominal as jn
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional as tF
import torchmetrics_tpu_torch.nominal as tn
from tests.torch_parity import assert_close, assert_states, engine_split, three_levels_args
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu_torch.engine import engine_context

C = 5
SIZES = (40, 33, 27)
RTOL = 1e-6
FLEISS_ATOL = 1e-5


def _labels(rng, n: int, kind: str):
    """A correlated pair: ``codes`` int64 labels, ``float`` float32 codes with NaN in
    either column, ``logits`` (n, C) float32 rows whose argmax is the label."""
    target = rng.integers(0, C, n)
    preds = np.where(rng.random(n) < 0.6, target, rng.integers(0, C, n))
    if kind == "codes":
        return preds, target
    if kind == "float":
        p, t = preds.astype(np.float32), target.astype(np.float32)
        p[rng.random(n) < 0.1] = np.nan
        t[rng.random(n) < 0.1] = np.nan
        return p, t
    eye = np.eye(C, dtype=np.float32)
    noise = lambda: rng.random((n, C)).astype(np.float32)  # noqa: E731
    return eye[preds] * 2 + noise(), eye[target] * 2 + noise()


def _ratings(rng, n: int, mode: str):
    """``counts``: (n, C) int64 rows of 6 raters each; ``probs``: (n, C, 4) float32."""
    if mode == "counts":
        picks = np.where(rng.random((n, 6)) < 0.5, rng.integers(0, C, (n, 1)), rng.integers(0, C, (n, 6)))
        return (picks[:, :, None] == np.arange(C)).sum(1).astype(np.int64)
    return rng.random((n, C, 4)).astype(np.float32)


def _batches(seed: int, kind: str, sizes=SIZES):
    rng = np.random.default_rng(seed)
    if kind in ("counts", "probs"):
        return [(_ratings(rng, n, kind),) for n in sizes]
    return [_labels(rng, n, kind) for n in sizes]


# (class, kwargs, data kind)
CASES = [
    ("CramersV", {"num_classes": C}, "codes"),
    ("CramersV", {"num_classes": C, "bias_correction": False, "nan_strategy": "drop"}, "float"),
    ("TschuprowsT", {"num_classes": C}, "logits"),
    ("TschuprowsT", {"num_classes": C, "bias_correction": False, "nan_replace_value": 2}, "float"),
    ("PearsonsContingencyCoefficient", {"num_classes": C, "nan_strategy": "drop"}, "float"),
    ("TheilsU", {"num_classes": C}, "logits"),
    ("TheilsU", {"num_classes": C, "nan_strategy": "drop"}, "float"),
    ("FleissKappa", {"mode": "counts"}, "counts"),
    ("FleissKappa", {"mode": "probs"}, "probs"),
]
_IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items() if k != 'num_classes')}-{kind}" for name, kw, kind in CASES]


@pytest.mark.parametrize("name, kwargs, kind", CASES, ids=_IDS)
def test_modular(name, kwargs, kind):
    atol, rtol = (FLEISS_ATOL, 0.0) if name == "FleissKappa" else (0.0, RTOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a small batch's bias correction warns, in both packages
        three_levels_args(
            lambda: getattr(tn, name)(**kwargs, device="cpu"),
            lambda: getattr(jn, name)(**kwargs),
            [(b, b) for b in _batches(0, kind)],
            atol, rtol,
        )


# ---------------------------------------------------------------- functionals

# (functional, kwargs, data kind); values: float codes with NaN, or any category values
_FUNCTIONAL = [
    (fn, kw, kind)
    for fn, extra in (
        ("cramers_v", ({}, {"bias_correction": False})),
        ("tschuprows_t", ({}, {"bias_correction": False})),
        ("pearsons_contingency_coefficient", ({},)),
        ("theils_u", ({},)),
    )
    for kw in extra
    for kind in ("codes", "logits")
] + [
    (fn, {"nan_strategy": "drop"}, "float")
    for fn in ("cramers_v", "tschuprows_t", "pearsons_contingency_coefficient", "theils_u")
] + [
    ("cramers_v", {"nan_replace_value": 7.5}, "float"),
    ("theils_u", {"nan_replace_value": -1}, "float"),
]


@pytest.mark.parametrize("fn, kwargs, kind", _FUNCTIONAL, ids=[f"{f}-{k}-{d}" for f, k, d in _FUNCTIONAL])
def test_functional(fn, kwargs, kind):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for preds, target in _batches(1, kind):
            if kind == "codes":  # arbitrary category values: the functionals densify them
                preds, target = preds * 10 - 3, (target * 0.5).astype(np.float32)
            assert_close(
                getattr(tF, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
                getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                0.0, RTOL, f"{fn} {kwargs}",
            )


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_functional(mode):
    for (ratings,) in _batches(2, mode):
        assert_close(tF.fleiss_kappa(torch.from_numpy(ratings), mode), jF.fleiss_kappa(jnp.asarray(ratings), mode),
                     FLEISS_ATOL, msg=mode)


@pytest.mark.parametrize(
    "fn, kwargs",
    [("cramers_v_matrix", {}), ("cramers_v_matrix", {"bias_correction": False, "nan_strategy": "drop"}),
     ("tschuprows_t_matrix", {}), ("pearsons_contingency_coefficient_matrix", {"nan_replace_value": 3.0}),
     ("theils_u_matrix", {}), ("theils_u_matrix", {"nan_strategy": "drop"})],
)
def test_matrix(fn, kwargs):
    """Five columns of other cardinalities (2 to 9 values, one of them floats with NaN)."""
    rng = np.random.default_rng(3)
    n = 120
    base = rng.integers(0, 9, n)
    cols = [base, base % 2, (base + rng.integers(0, 3, n)) % 7, rng.integers(0, 4, n), base // 3]
    matrix = np.stack(cols, 1).astype(np.float32)
    matrix[rng.random(n) < 0.05, 3] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = getattr(tF, fn)(torch.from_numpy(matrix), **kwargs)
        want = getattr(jF, fn)(jnp.asarray(matrix), **kwargs)
    assert got.dtype == torch.float32 and got.shape == (5, 5)
    assert_close(got, want, 0.0, RTOL, fn)


def test_replace_drops_codes_that_cast_out_of_range():
    """``"replace"`` turns ±inf into the float extremes and NaN into the replacement; a
    code outside ``(-1, num_classes)`` is dropped in both packages, and one in
    ``(-1, 0)`` truncates to 0 as the JAX cast does."""
    preds = np.array([0, 1, np.inf, -np.inf, 7.0, -0.5, 2.7, np.nan, 4.0, 3e9, -2.0, 1.0], dtype=np.float32)
    target = np.array([0, 1, 2, 3, 4, 0, 2, 1, np.nan, 3, 1, -np.inf], dtype=np.float32)
    for value in (0.0, 1e10):
        port = tn.CramersV(C, nan_replace_value=value, device="cpu")
        ref = jn.CramersV(C, nan_replace_value=value)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert_states(port, ref)
        assert int(port.confmat.sum()) == (6 if value == 0.0 else 4)


def test_argument_errors():
    for make in (lambda **k: tn.CramersV(3, **k), lambda **k: tn.TheilsU(3, **k)):
        with pytest.raises(ValueError, match="nan_strategy"):
            make(nan_strategy="zero", device="cpu")
        with pytest.raises(ValueError, match="nan_replace"):
            make(nan_replace_value="a", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tn.FleissKappa(mode="votes", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tF.fleiss_kappa(torch.ones(2, 2, dtype=torch.int64), mode="votes")
    with pytest.raises(ValueError, match="3 dimensions"):
        tF.fleiss_kappa(torch.ones(2, 3), mode="probs")
    with pytest.raises(ValueError, match="2 dimensions"):
        tF.fleiss_kappa(torch.ones(2, 3), mode="counts")
    with pytest.raises(ValueError, match="nan_strategy"):
        tF.theils_u_matrix(torch.ones(4, 2), nan_strategy="zero")


def test_bias_correction_warns_and_gives_nan():
    """A 2 x 2 table of two rows: the corrected shape reaches 1 and both packages warn."""
    preds, target = np.array([0, 1]), np.array([0, 1])
    for fn in ("cramers_v", "tschuprows_t"):
        with pytest.warns(UserWarning, match="bias correction"):
            got = getattr(tF, fn)(torch.from_numpy(preds), torch.from_numpy(target))
        assert np.isnan(float(got)) and np.isnan(float(getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target))))


def test_dense_update_reads_the_host_once_and_compute_once(monkeypatch):
    """The functional path's host reads: ``torch.unique`` sizes the table, and the
    compute reads the table, once each; the modular update reads nothing."""
    from torchmetrics_tpu_torch.functional.nominal import utils

    reads = []
    real_unique, real_host = torch.unique, utils._host_table
    monkeypatch.setattr(utils.torch, "unique", lambda *a, **k: reads.append("unique") or real_unique(*a, **k))
    monkeypatch.setattr(utils, "_host_table", lambda cm: reads.append("table") or real_host(cm))
    from torchmetrics_tpu_torch.functional.nominal import cramers

    monkeypatch.setattr(cramers, "_host_table", utils._host_table)
    preds, target = _batches(4, "float")[0]
    tF.cramers_v(torch.from_numpy(preds), torch.from_numpy(target), nan_strategy="drop")
    assert reads == ["unique", "table"]
    reads.clear()
    m = tn.CramersV(C, nan_strategy="drop", device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert reads == []
    m.compute()
    assert reads == ["table"]


# ---------------------------------------------------------------- the engine and the collection

_TABLES = ("CramersV", "TschuprowsT", "PearsonsContingencyCoefficient", "TheilsU")


@pytest.mark.parametrize("name", _TABLES)
def test_engine_split_replace(name):
    """``"replace"`` replays in both engines, with the engine state bit-equal to eager."""
    st = engine_split(
        lambda: getattr(tn, name)(C, device="cpu"), lambda: getattr(jn, name)(C),
        [(b, b) for b in _batches(5, "float")],
    )
    assert (st.dispatches, st.eager_fallbacks) == (len(SIZES), 0)


@pytest.mark.parametrize("name", _TABLES)
def test_engine_drop_path_replays_where_jax_falls_back(name):
    """``"drop"``: the port masks the dropped rows and replays every update; the JAX
    engine falls back (its boolean index has a data-dependent shape). The tables are
    equal to the JAX package's, and the engine's bit-equal to the port's eager run."""
    batches = _batches(6, "float")
    with jax.enable_x64(False), jax_engine_context(True, donate=True):
        ref = getattr(jn, name)(C, nan_strategy="drop")
        for p, t in batches:
            ref.update(jnp.asarray(p), jnp.asarray(t))
    jst = ref._engine.stats
    assert (jst.dispatches, jst.eager_fallbacks) == (0, len(SIZES))
    runs = {}
    for on in (True, False):
        with engine_context(on):
            runs[on] = getattr(tn, name)(C, nan_strategy="drop", device="cpu")
            for p, t in batches:
                runs[on].update(torch.from_numpy(p), torch.from_numpy(t))
    st = runs[True]._engine.stats
    assert (st.dispatches, st.eager_fallbacks) == (len(SIZES), 0), st.as_dict()
    assert_states(runs[True], runs[False])
    assert_states(runs[True], ref)
    assert_close(runs[True].compute(), ref.compute(), 0.0, RTOL)


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_engine_fleiss_falls_back(mode):
    st = engine_split(
        lambda: tn.FleissKappa(mode, device="cpu"), lambda: jn.FleissKappa(mode), [(b, b) for b in _batches(7, mode)]
    )
    assert (st.dispatches, st.eager_fallbacks) == (0, len(SIZES)) and dict(st.fallback_reasons) == {"list-state": 3}


def test_collection_groups_the_four_tables():
    """The four table metrics share one compute group beside an accuracy, found by value
    at the first update in both packages (no member declares a reduction signature)."""

    def members(pkg, cls, **device):
        out = {n.lower(): getattr(pkg, n)(C, **device) for n in _TABLES}
        out["acc"] = cls.MulticlassAccuracy(C, **device)
        return out

    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu_torch.classification as tc

    port = ttm.MetricCollection(members(tn, tc, device="cpu"))
    ref = jtm.MetricCollection(members(jn, jc))
    assert len(port.compute_groups) == 5  # nothing merges before the first update
    rng = np.random.default_rng(8)
    for n in SIZES:  # ImageNet-style: logits against labels
        p, _ = _labels(rng, n, "logits")
        t = rng.integers(0, C, n)
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    groups = {frozenset(g) for g in port.compute_groups.values()}
    tables = frozenset(n.lower() for n in _TABLES)
    assert groups == {frozenset(g) for g in ref.compute_groups.values()} == {tables, frozenset({"acc"})}
    assert_close(port.compute(), ref.compute(), 1e-6, RTOL)


@pytest.mark.parametrize(
    "module",
    [f"torchmetrics_tpu_torch.{pkg}nominal.{m}" for pkg in ("", "functional.")
     for m in ("cramers", "tschuprows", "pearson", "theils_u", "fleiss_kappa")],
)
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
