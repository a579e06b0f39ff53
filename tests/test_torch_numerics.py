"""The port's compensated accumulation (``torchmetrics_tpu_torch/engine/numerics.py``)
against the JAX package's (``torchmetrics_tpu/engine/numerics.py``), on the CPU.

Many small float32 increments on a large anchor: a naive float32 sum drifts (an
increment under half an ulp of the accumulator is lost), the compensated one stays
within 2 ulp of a float64 reference. The (value, residual) pairs must agree with the
JAX package's on the engine and eagerly, on two kinds of data:

- ``dyadic``: every increment is ``(k * 2**-12) ** 2``, so every partial sum of a batch
  is exact in float32 whatever the order, and the same two-sum steps give the same
  bits: the pairs must be bit-equal;
- ``random``: torch and XLA add a batch in different orders, so each batch's sum may
  round differently (2 ulp of its contribution). The value is held at relative 1e-6
  and the residual through the pair's exact sum, with only those per-batch roundings
  as slack: a residual dropped, zeroed or of the wrong sign misses it by a sub-ulp of
  the anchor, orders of magnitude more.

``reanchor`` at ``compute``, the anchored ``state_dict``, the two-sum folds of
``merge_state`` and of ``forward``, and the packed sync's fold
(``parallel/packing.py``, against the JAX plan's fold on the same gathered buffers)
are held the same way.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.engine import numerics as jax_numerics
from torchmetrics_tpu.engine.scan import scan_context as jax_scan_context
from torchmetrics_tpu.parallel.packing import PackedSyncPlan as JaxPackedSyncPlan
from torchmetrics_tpu_torch.engine import engine_context, numerics
from torchmetrics_tpu_torch.engine.numerics import compensated_context
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

ANCHOR = np.float32(1e4)
STEP = np.float32(1e-4)  # under half an ulp of 1e4 (ulp = 2**-10): a naive add loses it
N_UPDATES, WIDTH = 64, 32


DATA = ["random", "dyadic"]


def _increments(seed: int = 0, data: str = "random") -> list:
    rng = np.random.RandomState(seed)
    if data == "dyadic":
        # squares of k * 2**-12: a batch's sum of at most 32 * 50**2 units of 2**-24 is
        # exact in float32, and so is the square root the squared-error stream feeds
        return [((rng.randint(30, 51, WIDTH) * np.float32(2**-12)) ** 2).astype(np.float32) for _ in range(N_UPDATES)]
    return [(STEP * (0.5 + rng.rand(WIDTH))).astype(np.float32) for _ in range(N_UPDATES)]


def _reference_sum(xs) -> np.float64:
    return np.float64(ANCHOR) + sum(np.float64(x.astype(np.float64).sum()) for x in xs)


def _ulp(x: float) -> float:
    return float(np.spacing(np.float32(x)))


class _SquaredError:
    """The ``MeanSquaredError`` shape (one additive float sum of squares and a count),
    defined alike in both packages: the port has no regression module yet."""

    @staticmethod
    def make(side: str):
        base = tm.Metric if side == "port" else jtm.Metric
        zeros = (lambda: torch.zeros(())) if side == "port" else (lambda: jnp.zeros((), jnp.float32))
        count0 = torch.zeros((), dtype=torch.int32) if side == "port" else jnp.zeros((), jnp.int32)

        class SquaredError(base):
            full_state_update = False
            _engine_state_additive = True

            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("sum_squared_error", zeros(), dist_reduce_fx="sum")
                self.add_state("total", count0, dist_reduce_fx="sum")

            def update(self, preds, target):
                diff = preds - target
                self.sum_squared_error = self.sum_squared_error + (diff * diff).sum()
                self.total = self.total + int(np.prod(diff.shape))

            def compute(self):
                return self.sum_squared_error / self.total

        return SquaredError(**({"device": "cpu"} if side == "port" else {}))


def _make(side: str, kind: str):
    pkg = tm if side == "port" else jtm
    dev = {"device": "cpu"} if side == "port" else {}
    if kind == "sum":
        return pkg.SumMetric(nan_strategy=0.0, **dev)
    if kind == "mean":
        return pkg.MeanMetric(nan_strategy=0.0, **dev)
    return _SquaredError.make(side)


def _feed(m, kind: str, xs, conv):
    if kind == "squared_error":
        m.update(conv(np.full(4, np.sqrt(ANCHOR / 4), np.float32)), conv(np.zeros(4, np.float32)))
        for x in xs:
            m.update(conv(np.sqrt(x)), conv(np.zeros_like(x)))
    else:
        m.update(conv(np.full(1, ANCHOR, np.float32)))
        for x in xs:
            m.update(conv(x))


def _assert_pair_close(pair, ref_pair, xs, data: str) -> None:
    """``(value, residual)`` against the JAX package's pair (see the module docstring)."""
    value, residual = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in pair)
    ref_value, ref_residual = (np.asarray(x) for x in ref_pair)
    if data == "dyadic":
        np.testing.assert_array_equal(value, ref_value)
        np.testing.assert_array_equal(residual, ref_residual)
        return
    np.testing.assert_allclose(value, ref_value, rtol=1e-6)
    # the anchor batch is exact on both sides: only the increments' batches may round apart
    slack = sum(2 * _ulp(float(x.astype(np.float64).sum())) for x in xs)
    exact, ref_exact = (float(np.float64(v) + np.float64(r)) for v, r in ((value, residual), (ref_value, ref_residual)))
    assert abs(exact - ref_exact) <= slack


def _port_conv(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- policy and two-sum


@pytest.mark.parametrize("raw", ["", "0", "off", "1", "on", "ON", "2", "yes"])
def test_env_var_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("TORCHMETRICS_TPU_COMPENSATED", raw)
    try:
        want = jax_numerics.compensated_enabled()
    except Exception as err:  # noqa: BLE001
        with pytest.raises(TorchMetricsUserError) as port_err:
            numerics.compensated_enabled()
        assert str(port_err.value) == str(err)
        return
    assert numerics.compensated_enabled() == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_sum_is_exact_and_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a = (rng.randn(1000) * 10.0 ** rng.randint(-8, 8, 1000)).astype(np.float32)
    b = (rng.randn(1000) * 10.0 ** rng.randint(-8, 8, 1000)).astype(np.float32)
    s, err = numerics.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    # s + err is a + b exactly
    np.testing.assert_array_equal(s.double().numpy() + err.double().numpy(), a.astype(np.float64) + b.astype(np.float64))
    js, jerr = jax_numerics.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


def test_comp_state_names_match_jax():
    for kind in ("sum", "mean", "squared_error"):
        assert numerics.comp_state_names(_make("port", kind)) == jax_numerics.comp_state_names(_make("jax", kind))
    assert numerics.comp_state_names(tm.MaxMetric(device="cpu")) == ()
    assert numerics.comp_state_names(tm.MulticlassAccuracy(3, device="cpu")) == ()


# ---------------------------------------------------------------- long streams


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("kind", ["sum", "mean", "squared_error"])
@pytest.mark.parametrize("path", ["engine", "eager", "scan"])
def test_compensated_stream_matches_jax_and_float64(kind, path, data):
    xs = _increments(seed=len(kind), data=data)
    engine = path != "eager"
    with engine_context(engine), compensated_context(True):
        port = _make("port", kind)
        if path == "scan":
            port.scan_steps = 16
        _feed(port, kind, xs, _port_conv)
        port._drain_scan("test")
        value_attr = "sum_squared_error" if kind == "squared_error" else "value"
        pair = (getattr(port, value_attr).clone(), port._comp_residuals[value_attr].clone())
        if engine:
            assert port._engine.stats.compensated_steps == N_UPDATES + 1
            assert port._engine.stats.eager_fallbacks == 0
        value = port.compute()
    jax_ctx = jax_engine_context(True, donate=True) if engine else jax_engine_context(False)
    with jax_ctx, jax_numerics.compensated_context(True):
        if path == "scan":
            with jax_scan_context(16):
                ref = _make("jax", kind)
                _feed(ref, kind, xs, jnp.asarray)
                ref._drain_scan("test")
        else:
            ref = _make("jax", kind)
            _feed(ref, kind, xs, jnp.asarray)
        ref_pair = (np.asarray(getattr(ref, value_attr)), np.asarray(ref._comp_residuals[value_attr]))
        ref_value = ref.compute()
    _assert_pair_close(pair, ref_pair, xs, data)
    np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value), rtol=1e-6)
    if kind == "sum":
        want = _reference_sum(xs)
        anchored = float(pair[0].double() + pair[1].double())
        assert abs(anchored - want) <= 2 * _ulp(want)
        assert abs(float(value) - want) <= 2 * _ulp(want)
        naive = _make("port", kind)
        _feed(naive, kind, xs, _port_conv)
        assert abs(float(naive.compute()) - want) > 8 * _ulp(want)  # the drift compensation removes


def test_reanchor_at_compute_and_anchored_state_dict():
    xs = _increments(seed=7)
    with engine_context(True), compensated_context(True):
        port = _make("port", "sum")
        _feed(port, "sum", xs, _port_conv)
        value, residual = port.value.clone(), port._comp_residuals["value"].clone()
        assert float(residual) != 0.0
        port.persistent(True)
        saved = port.state_dict()
        anchored = numerics.two_sum(value, residual)[0]
        assert torch.equal(saved["value"], anchored)
        reanchors = port._engine.stats.reanchors
        out = port.compute()
        assert port._engine.stats.reanchors == reanchors + 1
        assert torch.equal(out, anchored)
        restored = _make("port", "sum")
        restored.load_state_dict(saved)
        assert torch.equal(restored.value, anchored)
    with jax_engine_context(True, donate=True), jax_numerics.compensated_context(True):
        ref = _make("jax", "sum")
        _feed(ref, "sum", xs, jnp.asarray)
        ref.persistent(True)
        np.testing.assert_allclose(saved["value"].numpy(), np.asarray(ref.state_dict()["value"]), rtol=1e-6)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_merge_state_folds_by_two_sum(kind, data):
    xs = _increments(seed=9, data=data)
    half = len(xs) // 2
    with engine_context(True), compensated_context(True):
        a, b = _make("port", kind), _make("port", kind)
        _feed(a, kind, xs[:half], _port_conv)
        _feed(b, kind, xs[half:], _port_conv)
        a.merge_state(b)
        pair = (a.value.clone(), a._comp_residuals["value"].clone())
        merged = a.compute()
    with jax_engine_context(True, donate=True), jax_numerics.compensated_context(True):
        ja, jb = _make("jax", kind), _make("jax", kind)
        _feed(ja, kind, xs[:half], jnp.asarray)
        _feed(jb, kind, xs[half:], jnp.asarray)
        ja.merge_state(jb)
        ref_pair = (np.asarray(ja.value), np.asarray(ja._comp_residuals["value"]))
        ref = ja.compute()
    _assert_pair_close(pair, ref_pair, xs, data)
    np.testing.assert_allclose(np.asarray(merged), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("data", DATA)
def test_forward_reduce_path_folds_by_two_sum(data):
    xs = _increments(seed=10, data=data)
    with engine_context(True), compensated_context(True):
        port = _make("port", "sum")
        _feed(port, "sum", [], _port_conv)
        for x in xs:
            port(_port_conv(x))
        pair = (port.value.clone(), port._comp_residuals["value"].clone())
    with jax_engine_context(True, donate=True), jax_numerics.compensated_context(True):
        ref = _make("jax", "sum")
        _feed(ref, "sum", [], jnp.asarray)
        for x in xs:
            ref(jnp.asarray(x))
    _assert_pair_close(pair, (ref.value, ref._comp_residuals["value"]), xs, data)
    want = _reference_sum(xs)
    assert abs(float(pair[0].double() + pair[1].double()) - want) <= 2 * _ulp(want)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_packed_sync_folds_the_residuals(kind, data):
    """Two ranks' (value, residual) pairs through the plan's fold, from the buffers each
    rank packs: the synced pairs are bit-equal to the JAX plan's fold of the same
    gathered buffers, and to its own end to end on dyadic data; the synced total equals
    the ``merge_state`` fold's re-anchored total."""
    xs = _increments(seed=11, data=data)
    half = len(xs) // 2
    with compensated_context(True):
        ranks = [_make("port", kind), _make("port", kind)]
        _feed(ranks[0], kind, xs[:half], _port_conv)
        _feed(ranks[1], kind, xs[half:], _port_conv)
        plans = [PackedSyncPlan([("", m)], 2) for m in ranks]
        for plan in plans:
            # MeanMetric's value and weight are sum-reduced too: both fold as pairs
            assert [s.kind for s in plan.specs if s.attr == "value"] == ["comp-sum", "comp-res"]
            plan.finalize(None)
        packed = [plan.pack() for plan in plans]
        gathered = {key: torch.stack([p[key] for p in packed]) for key in packed[0]}
        folded = plans[0].make_fold()(gathered)[""]
        total, res = folded["value"], folded[numerics.SYNC_RES_PREFIX + "value"]
        a = _make("port", kind)
        _feed(a, kind, xs[:half], _port_conv)
        b = _make("port", kind)
        _feed(b, kind, xs[half:], _port_conv)
        a.merge_state(b)
    with jax_numerics.compensated_context(True):
        jax_ranks = [_make("jax", kind), _make("jax", kind)]
        _feed(jax_ranks[0], kind, xs[:half], jnp.asarray)
        _feed(jax_ranks[1], kind, xs[half:], jnp.asarray)
        jax_plans = [JaxPackedSyncPlan([("", m)], 2) for m in jax_ranks]
        for plan in jax_plans:
            plan.finalize(None)
        jax_fold = jax_plans[0].make_fold()
        same_buffers = jax_fold({key: jnp.asarray(v.numpy()) for key, v in gathered.items()})[""]
        jax_packed = [plan.pack() for plan in jax_plans]
        own = jax_fold({key: jnp.stack([p[key] for p in jax_packed]) for key in jax_packed[0]})[""]
    for attr, out in folded.items():
        np.testing.assert_array_equal(out.numpy(), np.asarray(same_buffers[attr]))
        if data == "dyadic":
            np.testing.assert_array_equal(out.numpy(), np.asarray(own[attr]))
    synced = float(total.double() + res.double())
    merged = float(a.value.double() + a._comp_residuals["value"].double())
    want = _reference_sum(xs) + np.float64(ANCHOR)  # each rank holds the anchor once
    assert abs(synced - merged) <= 2 * _ulp(want)
    assert abs(synced - want) <= 2 * _ulp(want)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_packed_sync_fold_matches_jax_on_residual_heavy_buffers(kind, world):
    """The fold alone, on gathered buffers whose values span seven decades and whose
    residuals reach 1.5 ulp of their values, as a ``merge_state`` fold leaves them (two
    half-ulp residuals and a half-ulp fold error). The rank increment
    ``value + residual + carried`` rounds left to right in both packages: a residual
    under half an ulp of its value is absorbed there, and the carried one survives only
    a small value. These buffers make both move the synced pair, so a fold that drops
    either is caught. The port's fold must give the JAX plan's bits."""
    rng = np.random.RandomState(world)
    with compensated_context(True):
        plan = PackedSyncPlan([("", _make("port", kind))], world)
        plan.finalize(None)
    with jax_numerics.compensated_context(True):
        jax_plan = JaxPackedSyncPlan([("", _make("jax", kind))], world)
        jax_plan.finalize(None)
    (key, width), = plan._group_sizes.items()
    assert jax_plan._group_sizes == {key: width}
    fold, jax_fold = plan.make_fold(), jax_plan.make_fold()
    moved = 0
    for _ in range(64):
        buf = np.empty((world, width), np.float32)
        values = (10.0 ** rng.uniform(-3, 4, (world, width // 2))).astype(np.float32)
        buf[:, 0::2] = values
        buf[:, 1::2] = (rng.uniform(-1.5, 1.5, values.shape) * np.spacing(values)).astype(np.float32)
        out = fold({key: torch.from_numpy(buf)})[""]
        ref = jax_fold({key: jnp.asarray(buf)})[""]
        assert out.keys() == ref.keys()
        for attr, value in out.items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(ref[attr]))
        bare = buf.copy()
        bare[:, 1::2] = 0.0
        without = fold({key: torch.from_numpy(bare)})[""]
        moved += any(not torch.equal(value, without[attr]) for attr, value in out.items())
    assert moved >= 8  # the residuals moved a share of the synced pairs
