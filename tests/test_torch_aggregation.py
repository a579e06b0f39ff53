"""The port's aggregators against the JAX package's, on the CPU.

Seven aggregators (Max, Min, Sum, Cat, Mean, RunningMean, RunningSum) under every NaN
strategy, on ragged batches, on Python numbers and on batches with NaN and inf, at
the three protocol levels of ``tests/differential/harness.py``: each batch's
``forward`` value, the epoch ``compute``, and the ``merge_state`` fold of two replicas.
Max, Min and Cat must agree exactly; Sum and Mean within relative 1e-6 (the two
packages sum in another order). Also ``set_dtype(float64)`` and the update engine:
a float strategy replays as a graph with no fallback, the others fall back, counted.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.engine import engine_context

SUM_RTOL = 1e-6
EXACT = ("MaxMetric", "MinMetric", "CatMetric")
NAMES = ("MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric", "RunningMean", "RunningSum")
STRATEGIES = ("error", "warn", "ignore", 0.0, -2.5)

_RNG = np.random.default_rng(7)
_RAGGED = [_RNG.standard_normal(n).astype(np.float32) for n in (5, 1, 7, 3)]
_WITH_NAN = [b.copy() for b in _RAGGED]
_WITH_NAN[0][2] = np.nan
_WITH_NAN[2][[0, 6]] = np.nan
_WITH_INF = [b.copy() for b in _RAGGED]
_WITH_INF[0][1] = np.inf
_WITH_INF[2][3] = -np.inf
INPUTS = {
    "ragged": _RAGGED,
    "nan": _WITH_NAN,
    "inf": _WITH_INF,
    "scalars": [1.5, -2.0, 3, np.float32(0.25)],
    "zero-d": [np.asarray(v, dtype=np.float32) for v in (0.5, -1.25, 4.0)],
}


def _make(name, strategy, package, **kwargs):
    cls = getattr(package, name)
    if name.startswith("Running"):
        kwargs["window"] = 2
    if package is tm:
        kwargs["device"] = "cpu"
    return cls(nan_strategy=strategy, **kwargs)


def _port_in(x):
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x


def _jax_in(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _assert_value(got, want, name, msg):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, f"{msg}: {got.shape} vs {want.shape}"
    if name in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=0, err_msg=msg)


def _has_nan(batches):
    return any(np.isnan(np.asarray(b, dtype=np.float64)).any() for b in batches)


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_aggregator_matches_jax(name, strategy, inputs):
    batches = INPUTS[inputs]
    port, ref = _make(name, strategy, tm), _make(name, strategy, jtm)
    if strategy == "error" and _has_nan(batches):
        with pytest.raises(RuntimeError, match="nan"):
            ref.update(_jax_in(batches[0]))
        with pytest.raises(RuntimeError, match="nan"):
            port.update(_port_in(batches[0]))
        return
    for i, b in enumerate(batches):
        with warnings.catch_warnings(record=True) as ref_warned:
            warnings.simplefilter("always")
            want = ref(_jax_in(b))
        with warnings.catch_warnings(record=True) as port_warned:
            warnings.simplefilter("always")
            got = port(_port_in(b))
        nan_warning = lambda caught: any("nan" in str(w.message) for w in caught)  # noqa: E731
        assert nan_warning(port_warned) == nan_warning(ref_warned), f"forward {i}: NaN warning"
        _assert_value(got, want, name, f"forward {i}")
    _assert_value(port.compute(), ref.compute(), name, "compute")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pa, pb = _make(name, strategy, tm), _make(name, strategy, tm)
        ra, rb = _make(name, strategy, jtm), _make(name, strategy, jtm)
        half = len(batches) // 2
        for i, b in enumerate(batches):
            (pa if i < half else pb).update(_port_in(b))
            (ra if i < half else rb).update(_jax_in(b))
        pa.merge_state(pb)
        ra.merge_state(rb)
        _assert_value(pa.compute(), ra.compute(), name, "merge_state")


@pytest.mark.parametrize("strategy", ["warn", 0.0])
def test_weighted_mean_matches_jax(strategy):
    port, ref = _make("MeanMetric", strategy, tm), _make("MeanMetric", strategy, jtm)
    for b in _RAGGED:
        w = np.abs(_RNG.standard_normal(b.shape)).astype(np.float32)
        port.update(torch.from_numpy(b), weight=torch.from_numpy(w))
        ref.update(jnp.asarray(b), weight=jnp.asarray(w))
    port.update(torch.from_numpy(_RAGGED[0]), weight=2.0)
    ref.update(jnp.asarray(_RAGGED[0]), weight=2.0)
    for attr in ("value", "weight"):
        np.testing.assert_allclose(getattr(port, attr).numpy(), np.asarray(getattr(ref, attr)), rtol=SUM_RTOL)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=SUM_RTOL)


def test_mean_nan_value_with_full_weight_raises_in_both():
    """The JAX package's quirk, copied: NaNs stripped from the value, not from a tensor weight."""
    value = np.array([1.0, np.nan, 2.0], dtype=np.float32)
    weight = np.ones(3, dtype=np.float32)
    with pytest.raises(ValueError):
        _make("MeanMetric", "ignore", jtm).update(jnp.asarray(value), weight=jnp.asarray(weight))
    with pytest.raises(RuntimeError):
        _make("MeanMetric", "ignore", tm).update(torch.from_numpy(value), weight=torch.from_numpy(weight))


@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric"])
def test_set_dtype_float64_matches_jax(name):
    port, ref = _make(name, 0.0, tm).set_dtype(torch.float64), _make(name, 0.0, jtm).set_dtype(jnp.float64)
    assert port.dtype == torch.float64
    for b in _RAGGED:
        port.update(torch.from_numpy(b))
        ref.update(jnp.asarray(b))
    for attr in port._defaults:
        got, want = getattr(port, attr), getattr(ref, attr)
        if isinstance(got, list):
            got, want = torch.cat(got), jnp.concatenate(want)
        assert got.dtype == (torch.float32 if name == "CatMetric" else torch.float64), attr
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SUM_RTOL, err_msg=attr)
    _assert_value(port.compute(), ref.compute(), name, "compute")


@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric"])
def test_float_strategy_replays_with_no_fallback(name):
    batches = [torch.from_numpy(b) for b in _WITH_NAN[:1] * 4]
    eager = _make(name, 0.0, tm)
    for b in batches:
        eager.update(b)
    with engine_context(True):
        engine = _make(name, 0.0, tm)
        for b in batches:
            engine.update(b)
    st = engine._engine.stats
    assert (st.dispatches, st.traces, st.eager_fallbacks) == (4, 1, 0)
    for attr in engine._defaults:
        assert torch.equal(getattr(engine, attr), getattr(eager, attr)), attr


@pytest.mark.parametrize(
    ("name", "strategy", "reason"),
    [
        ("MeanMetric", "warn", "host-read"),
        ("SumMetric", "error", "host-read"),
        ("MaxMetric", "ignore", "host-read"),
        ("CatMetric", 0.0, "list-state"),
        ("CatMetric", "warn", "list-state"),
    ],
)
def test_host_reading_strategies_fall_back_counted(name, strategy, reason):
    batches = [torch.from_numpy(b) for b in _RAGGED[:1] * 3]
    eager = _make(name, strategy, tm)
    with engine_context(True):
        engine = _make(name, strategy, tm)
        for b in batches:
            engine.update(b)
            eager.update(b)
    st = engine._engine.stats
    assert st.dispatches == 0 and st.eager_fallbacks == 3, st.as_dict()
    assert any(r.startswith(reason) for r in st.fallback_reasons), st.fallback_reasons
    _assert_value(engine.compute(), eager.compute(), name, "engine vs eager")
