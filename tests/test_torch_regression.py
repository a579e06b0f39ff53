"""Regression's sum-state metrics: the port (on the CPU) against the JAX package.

MSE / RMSE, MAE, MSLE, MAPE, SMAPE, WMAPE, Minkowski, log-cosh, R², RSE, explained
variance and Tweedie deviance, modular at the three protocol levels of
``tests/differential/harness.py`` (``torch_parity.three_levels``) and functional, on
ragged seeded batches of positive log-normal targets. Edge cases: ``num_outputs=8``
(MSE, log-cosh, R² raw values), adjusted R², R² below two samples, integer MAE inputs,
every Tweedie power and its domain errors. Under the compiled engine every metric
replays where the JAX engine compiles (Tweedie at power 1.5 included: its domain
checks skip inside the engine's update body), with the engine state bit-equal to
eager. A regression collection's compute groups equal the JAX collection's, and a
state carried from the JAX package finishes its stream in the port.

The JAX side runs in 32-bit mode here, the port's dtypes (float32 sums, int32 counts).
The inputs lie on a dyadic grid, so the polynomial sums (squared, absolute and signed
errors, Σy, Σy²) are exact whatever the order of addition, and the values derived from
them by a difference of sums (R², RSE, explained variance) meet the same tolerance.
Tolerances: counts exact; sums and values relative 1e-6 (a term through a log, a power
or a division may differ by an ulp between the packages, and a batch is added in
another order). Tweedie at a power outside {0, 1, 2} adds absolute 1e-6: each element's
deviance is a difference of power terms of order 1 (PyTorch takes ``x ** 0.5`` as a
square root, XLA through exp and log, an ulp apart), so a mean deviance of ~0.02 moves
by ~1e-7 absolute, which is several times 1e-6 of it; its summed state, 1e-6 per
element summed.
"""

from __future__ import annotations

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
from tests.torch_parity import assert_close, assert_states, engine_split, three_levels
from torchmetrics_tpu_torch.interop import collection_state_from_jax
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

RTOL = 1e-6
ATOL = 1e-7
SIZES = (24, 17, 9)
OUTPUTS = 8
TWEEDIE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _dyadic(x: np.ndarray) -> np.ndarray:
    """On a grid of 1/16 in [1/16, 8): every difference, square and sum of a batch is
    exact in float32, in any order of addition."""
    return np.clip(np.round(x * 16) / 16, 1 / 16, 8 - 1 / 16).astype(np.float32)


def _batches(seed: int, outputs: int = 0):
    """``(preds, target, preds)``: log-normal targets, predictions off by a log-normal
    relative error, both on the dyadic grid."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        shape = (n, outputs) if outputs else (n,)
        target = rng.lognormal(0.0, 0.5, shape)
        preds = _dyadic(target * rng.lognormal(0.0, 0.2, shape))
        out.append((preds, _dyadic(target), preds))
    return out


# (class name, kwargs, functional name or None, outputs)
CASES = [
    ("MeanSquaredError", {}, "mean_squared_error", 0),
    ("MeanSquaredError", {"squared": False}, "mean_squared_error", 0),
    ("MeanSquaredError", {"num_outputs": OUTPUTS}, "mean_squared_error", OUTPUTS),
    ("MeanAbsoluteError", {}, "mean_absolute_error", 0),
    ("MeanSquaredLogError", {}, "mean_squared_log_error", 0),
    ("MeanAbsolutePercentageError", {}, "mean_absolute_percentage_error", 0),
    ("SymmetricMeanAbsolutePercentageError", {}, "symmetric_mean_absolute_percentage_error", 0),
    ("WeightedMeanAbsolutePercentageError", {}, "weighted_mean_absolute_percentage_error", 0),
    ("MinkowskiDistance", {"p": 3}, "minkowski_distance", 0),
    ("MinkowskiDistance", {"p": 1.5}, "minkowski_distance", 0),
    ("LogCoshError", {}, "log_cosh_error", 0),
    ("LogCoshError", {"num_outputs": OUTPUTS}, "log_cosh_error", OUTPUTS),
    ("R2Score", {}, "r2_score", 0),
    ("R2Score", {"adjusted": 3}, "r2_score", 0),
    ("R2Score", {"num_outputs": OUTPUTS, "multioutput": "raw_values"}, "r2_score", OUTPUTS),
    ("R2Score", {"num_outputs": OUTPUTS, "multioutput": "variance_weighted"}, "r2_score", OUTPUTS),
    ("RelativeSquaredError", {}, "relative_squared_error", 0),
    ("RelativeSquaredError", {"squared": False}, "relative_squared_error", 0),
    ("ExplainedVariance", {}, "explained_variance", 0),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "explained_variance", OUTPUTS),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, "explained_variance", OUTPUTS),
    ("TweedieDevianceScore", {"power": 0.0}, "tweedie_deviance_score", 0),
    ("TweedieDevianceScore", {"power": 1}, "tweedie_deviance_score", 0),
    ("TweedieDevianceScore", {"power": 1.5}, "tweedie_deviance_score", 0),
    ("TweedieDevianceScore", {"power": 2}, "tweedie_deviance_score", 0),
    ("TweedieDevianceScore", {"power": 3}, "tweedie_deviance_score", 0),
    ("TweedieDevianceScore", {"power": -1.0}, "tweedie_deviance_score", 0),
]
_IDS = [f"{name}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for name, kw, _, _ in CASES]

def _atol(name: str, kwargs: dict) -> float:
    return TWEEDIE_ATOL if name == "TweedieDevianceScore" and kwargs["power"] not in (0, 1, 2) else ATOL


def _functional_kwargs(name: str, kwargs: dict) -> dict:
    """The class's kwargs as its functional form takes them (only MSE's has ``num_outputs``)."""
    out = {k: v for k, v in kwargs.items() if k != "num_outputs"}
    if name == "MeanSquaredError" and "num_outputs" in kwargs:
        out["num_outputs"] = kwargs["num_outputs"]
    return out


@pytest.mark.parametrize("name, kwargs, fn, outputs", CASES, ids=_IDS)
def test_modular(name, kwargs, fn, outputs):
    three_levels(
        lambda: getattr(tr, name)(**kwargs, device="cpu"),
        lambda: getattr(jr, name)(**kwargs),
        _batches(0, outputs), atol=_atol(name, kwargs), rtol=RTOL, float_state_rtol=RTOL,
        float_state_atol=0.0 if _atol(name, kwargs) == ATOL else TWEEDIE_ATOL * sum(SIZES),
    )


@pytest.mark.parametrize("name, kwargs, fn, outputs", CASES, ids=_IDS)
def test_functional(name, kwargs, fn, outputs):
    kw = _functional_kwargs(name, kwargs)
    for preds, target, _ in _batches(1, outputs):
        assert_close(
            getattr(tF, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw),
            getattr(jF, fn)(jnp.asarray(preds), jnp.asarray(target), **kw), _atol(name, kwargs), RTOL, fn,
        )


def test_state_shapes_and_dtypes():
    """0-d MSE / R² sums at one output, (num_outputs,) otherwise; log-cosh's float (1,)
    count; int32 counts."""
    for m, j in (
        (tr.MeanSquaredError(device="cpu"), jr.MeanSquaredError()),
        (tr.MeanSquaredError(num_outputs=OUTPUTS, device="cpu"), jr.MeanSquaredError(num_outputs=OUTPUTS)),
        (tr.R2Score(device="cpu"), jr.R2Score()),
        (tr.LogCoshError(device="cpu"), jr.LogCoshError()),
        (tr.ExplainedVariance(device="cpu"), jr.ExplainedVariance()),
        (tr.TweedieDevianceScore(device="cpu"), jr.TweedieDevianceScore()),
    ):
        for attr, default in j._defaults.items():
            got, want = getattr(m, attr), np.asarray(default)
            assert tuple(got.shape) == want.shape, (type(m).__name__, attr)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), (type(m).__name__, attr, got.dtype, want.dtype)


def test_integer_mae_inputs_in_float32():
    preds, target = np.array([1, 4, 2, 7]), np.array([2, 4, 0, 3])
    got = tr.MeanAbsoluteError(device="cpu")
    got.update(torch.from_numpy(preds), torch.from_numpy(target))
    want = jr.MeanAbsoluteError()
    want.update(jnp.asarray(preds), jnp.asarray(target))
    assert got.sum_abs_error.dtype == torch.float32
    assert_states(got, want)
    assert_close(got.compute(), want.compute(), 0.0)


def test_r2_edges():
    with pytest.raises(ValueError, match="at least two samples"):
        tF.r2_score(torch.tensor([1.0]), torch.tensor([2.0]))
    with pytest.raises(ValueError, match="at least two samples"):
        jF.r2_score(jnp.asarray([1.0]), jnp.asarray([2.0]))
    preds, target = torch.tensor([1.0, 2.0, 3.5, 4.0]), torch.tensor([1.5, 2.0, 3.0, 4.5])
    for adjusted in (3, 4):  # == n - 1 and > n - 1: fall back to the plain score, with a warning
        with pytest.warns(UserWarning, match="adjusted r2"):
            got = tF.r2_score(preds, target, adjusted=adjusted)
        assert_close(got, jF.r2_score(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy())), ATOL, RTOL)
    with pytest.raises(ValueError, match="adjusted"):
        tr.R2Score(adjusted=-1, device="cpu")
    with pytest.raises(ValueError, match="multioutput"):
        tr.R2Score(multioutput="mean", device="cpu")


@pytest.mark.parametrize(
    "power, preds, target, match",
    [
        (1, [1.0, -1.0], [1.0, 1.0], "strictly positive and 'targets' cannot be negative"),
        (1, [1.0, 1.0], [1.0, -1.0], "strictly positive and 'targets' cannot be negative"),
        (2, [1.0, 1.0], [1.0, 0.0], "both 'preds' and 'targets' have to be strictly positive"),
        (-1.0, [0.0, 1.0], [1.0, 1.0], "'preds' has to be strictly positive"),
        (1.5, [1.0, 0.0], [1.0, 1.0], "'targets' has to be strictly positive"),
        (3, [1.0, 1.0], [0.0, 1.0], "both 'preds' and 'targets' have to be strictly positive"),
        (0.5, [1.0, 1.0], [1.0, 1.0], "not defined for power=0.5"),
    ],
)
def test_tweedie_domain_errors(power, preds, target, match):
    with pytest.raises(ValueError, match=match):
        tF.tweedie_deviance_score(torch.tensor(preds), torch.tensor(target), power=power)
    with pytest.raises(ValueError, match=match):
        jF.tweedie_deviance_score(jnp.asarray(preds), jnp.asarray(target), power=power)
    if not 0 < power < 1:
        m = tr.TweedieDevianceScore(power=power, device="cpu")
        with pytest.raises(ValueError, match=match):
            m.update(torch.tensor(preds), torch.tensor(target))


def test_argument_errors():
    with pytest.raises(ValueError, match="num_outputs"):
        tr.MeanSquaredError(num_outputs=0, device="cpu")
    with pytest.raises(ValueError, match="squared"):
        tr.MeanSquaredError(squared=1, device="cpu")
    with pytest.raises(TorchMetricsUserError, match="``p``"):
        tr.MinkowskiDistance(p=0.5, device="cpu")
    with pytest.raises(ValueError, match="num_outputs"):
        tr.LogCoshError(num_outputs=2, device="cpu").update(torch.ones(3, 3), torch.ones(3, 3))
    with pytest.raises(ValueError, match="1- or 2-dimensional"):
        tF.log_cosh_error(torch.ones(3, 2, 2), torch.ones(3, 2, 2))
    with pytest.raises(ValueError, match="multioutput"):
        tr.ExplainedVariance(multioutput="mean", device="cpu")
    with pytest.raises(RuntimeError, match="same shape"):
        tF.mean_squared_error(torch.ones(3), torch.ones(4))


# ---------------------------------------------------------------- the engine


# explained variance's states are 0-d until a 2-D batch makes them (K,): see below
_FIXED_STATE_CASES = [c for c in CASES if not (c[0] == "ExplainedVariance" and c[3])]


@pytest.mark.parametrize(
    "name, kwargs, fn, outputs", _FIXED_STATE_CASES, ids=[i for c, i in zip(CASES, _IDS) if c in _FIXED_STATE_CASES]
)
def test_engine_replays_where_the_jax_engine_compiles(name, kwargs, fn, outputs):
    """Every sum-state update compiles in the JAX engine and replays in the port's, Tweedie
    at every power included; the engine states bit-equal to eager."""
    batches = [((p, t), (jp, t)) for p, t, jp in _batches(2, outputs)]
    st = engine_split(lambda: getattr(tr, name)(**kwargs, device="cpu"), lambda: getattr(jr, name)(**kwargs), batches)
    assert st.eager_fallbacks == 0 and st.dispatches == len(SIZES), dict(st.fallback_reasons)


def test_engine_explained_variance_on_2d_batches():
    """Divergence kept: the first 2-D batch turns explained variance's 0-d states into
    (K,) ones. The JAX engine traces that step and retraces the next; the port's writes
    a graph's states back into fixed buffers, so that one step runs eagerly (counted) and
    every later one replays. States and values equal the eager run's and the JAX run's."""
    from torchmetrics_tpu.engine import engine_context as jax_engine_context
    from torchmetrics_tpu_torch.engine import engine_context

    batches = _batches(2, OUTPUTS)
    with jax_engine_context(True, donate=True):
        ref = jr.ExplainedVariance(multioutput="raw_values")
        for _, t, jp in batches:
            ref.update(jnp.asarray(jp), jnp.asarray(t))
    with engine_context(True):
        port = tr.ExplainedVariance(multioutput="raw_values", device="cpu")
        for p, t, _ in batches:
            port.update(torch.from_numpy(p), torch.from_numpy(t))
    assert (ref._engine.stats.dispatches, ref._engine.stats.eager_fallbacks) == (len(SIZES), 0)
    st = port._engine.stats
    assert (st.dispatches, st.eager_fallbacks) == (len(SIZES) - 1, 1)
    assert dict(st.fallback_reasons) == {"update changes state 'sum_error' to Tensor torch.float32": 1}
    assert_states(port, ref, float_rtol=RTOL)
    assert_close(port.compute(), ref.compute(), ATOL, RTOL)


def test_tweedie_checks_run_eagerly_and_skip_under_the_engine():
    """Eagerly a domain error raises; under the engine the checks skip inside the update
    body (as the JAX engine's do under its tracer), so the update is captured."""
    from torchmetrics_tpu_torch.engine import engine_context

    bad = (torch.tensor([1.0, 0.0]), torch.tensor([1.0, 1.0]))
    with engine_context(False), pytest.raises(ValueError, match="strictly positive"):
        tr.TweedieDevianceScore(power=1.5, device="cpu").update(*bad)
    with engine_context(True):
        m = tr.TweedieDevianceScore(power=1.5, device="cpu")
        m.update(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 2.5]))
        m.update(*bad)
    assert m._engine.stats.dispatches == 2 and m._engine.stats.eager_fallbacks == 0


def _collection_members(pkg, **device):
    return {
        "mse": pkg.MeanSquaredError(**device),
        "rmse": pkg.MeanSquaredError(squared=False, **device),
        "mae": pkg.MeanAbsoluteError(**device),
        "msle": pkg.MeanSquaredLogError(**device),
        "mape": pkg.MeanAbsolutePercentageError(**device),
        "smape": pkg.SymmetricMeanAbsolutePercentageError(**device),
        "wmape": pkg.WeightedMeanAbsolutePercentageError(**device),
        "minkowski": pkg.MinkowskiDistance(p=3, **device),
        "logcosh": pkg.LogCoshError(**device),
        "r2": pkg.R2Score(**device),
        "rse": pkg.RelativeSquaredError(**device),
        "ev": pkg.ExplainedVariance(**device),
        "tweedie0": pkg.TweedieDevianceScore(power=0.0, **device),
        "tweedie15": pkg.TweedieDevianceScore(power=1.5, **device),
    }


def test_collection_compute_groups_and_values():
    """Groups found by value at the first update, as in the JAX collection: MSE with
    RMSE, R² with RSE; every value against the JAX collection's."""
    batches = _batches(3)
    port = ttm.MetricCollection(_collection_members(tr, device="cpu"))
    ref = jtm.MetricCollection(_collection_members(jr))
    for p, t, jp in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(jp), jnp.asarray(t))
    groups = {frozenset(g) for g in port.compute_groups.values()}
    assert groups == {frozenset(g) for g in ref.compute_groups.values()}
    assert frozenset({"mse", "rmse"}) in groups and frozenset({"r2", "rse"}) in groups
    assert_close(port.compute(), ref.compute(), ATOL, RTOL)


def test_collection_state_carried_from_jax():
    batches = _batches(4)
    ref = jtm.MetricCollection(_collection_members(jr))
    ref.persistent(True)
    for p, t, jp in batches[:2]:
        ref.update(jnp.asarray(jp), jnp.asarray(t))
    port = ttm.MetricCollection(_collection_members(tr, device="cpu"))
    port.load_state_dict(collection_state_from_jax(ref.state_dict(), "cpu"))
    for p, t, jp in batches[2:]:
        ref.update(jnp.asarray(jp), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    for name in ref.keys(keep_base=True):
        assert_states(port[name], ref[name], float_rtol=RTOL)
    assert_close(port.compute(), ref.compute(), ATOL, RTOL)
