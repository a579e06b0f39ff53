"""The port's serving states against the JAX package on the CPU: hashes, sketches,
windows, decay, tenancy, KLL quantiles, snapshot-compute and the state carried from
JAX.

The same numpy-seeded inputs go through both packages (x64 on, as ``conftest.py``
sets it). Hash words, HLL registers, count-min grids, top-k pairs, tenant tables and
KLL compactors must be bit-equal; float values are held on dyadic data (every sum
exact in any order), so they must be equal too. Values are compared, not dtypes: the
JAX package widens its counters to int64 in 64-bit mode, the port keeps int32 stat
counts and int64 serving counters.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.serve as js
import torchmetrics_tpu_torch.aggregation as ta
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.serve as ts
from torchmetrics_tpu.serve import quantile as jq
from torchmetrics_tpu.serve import sketch as jsk
from torchmetrics_tpu.utilities.exceptions import TorchMetricsUserError as JaxUserError
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.engine import engine_context
from torchmetrics_tpu_torch.engine.compiled import holds_nested_metrics
from torchmetrics_tpu_torch.interop import state_from_jax
from torchmetrics_tpu_torch.serve import quantile as tq
from torchmetrics_tpu_torch.serve import sketch as tsk
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


#: a computed accuracy: both sides divide equal counts in float32, and the macro mean
#: adds the per-class values in another order
ACC_ATOL = 1e-6


def _equal(got, want, msg: str = "", atol: float = 0.0) -> None:
    """Equal values (NaN equal to NaN), recursively over tuples and dicts; float values
    within ``atol`` where one is given."""
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _equal(got[k], want[k], f"{msg}[{k}]", atol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{msg}[{i}]", atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, f"{msg}: {g.shape} vs {w.shape}"
    if atol and g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=msg)
    else:
        np.testing.assert_array_equal(g, w, err_msg=msg)


def _states_equal(port, ref, msg: str = "") -> None:
    assert list(port._defaults) == list(ref._defaults), msg
    for attr in ref._defaults:
        _equal(getattr(port, attr), getattr(ref, attr), f"{msg}.{attr}")


def _dyadic(rng, shape, scale: int = 8):
    """Values on a 1/4 grid: every sum of a few hundred of them is exact in float32."""
    return (rng.integers(-scale * 4, scale * 4, shape) / 4.0).astype(np.float32)


# ---------------------------------------------------------------- hashes and sketches

SEEDS = (jsk._SEED_INDEX, jsk._SEED_RHO) + jsk._CMS_SEEDS


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_bit_equal(seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    words = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64), [0, 1, 2**31, 2**31 - 1, 2**32 - 1]])
    want = np.asarray(jsk.hash_u32(jnp.asarray(words.astype(np.uint32)), seed)).astype(np.int64)
    got = tsk.hash_u32(torch.from_numpy(words.astype(np.int64)), seed).numpy()
    np.testing.assert_array_equal(got, want)
    host = [tsk.hash_u32_host(int(w), seed) for w in words[:64]]
    np.testing.assert_array_equal(np.asarray(host), got[:64])
    assert tsk.hash_u32_host is not jsk.hash_u32_host
    assert [jsk.hash_u32_host(int(w), seed) for w in words[:64]] == host


_INT_EDGES = np.array(
    [0, 1, -1, -2, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7, 2**40 + 3, -(2**31), -(2**40), 2**63 - 1, -(2**63)],
    dtype=np.int64,
)
_FLOAT_EDGES = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.5, 3.0e38, 1e-40, 7.0], dtype=np.float64)


@pytest.mark.parametrize("dtype", ["int64", "int32", "float32", "float64"])
def test_canon_u32_edges(dtype):
    rng = np.random.default_rng(3)
    if dtype.startswith("int"):
        ids = np.concatenate([_INT_EDGES, rng.integers(-(2**45), 2**45, 512)]).astype(dtype)
    else:
        ids = np.concatenate([_FLOAT_EDGES, rng.normal(size=512) * 1e6]).astype(dtype)
    want = np.asarray(jsk.canon_u32(jnp.asarray(ids))).astype(np.int64)
    got = tsk.canon_u32(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    if dtype == "int64":
        nonneg = ids[ids >= 0][:64]
        np.testing.assert_array_equal([tsk.canon_u32_host(int(i)) for i in nonneg], got[ids >= 0][:64])


def test_rho_bit_equal():
    rng = np.random.default_rng(5)
    words = np.concatenate([[0, 1, 2, 3, 2**31, 2**32 - 1, 2**16, 2**16 - 1], rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    want = np.asarray(jax.lax.clz(jnp.asarray(words.astype(np.uint32))) + 1)
    got = tsk._rho(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p, kind", [(4, "int"), (10, "int"), (8, "float")])
def test_hll_registers(p, kind):
    rng = np.random.default_rng(p)
    ref, port = js.CardinalitySketch(p=p), ts.CardinalitySketch(p=p, device="cpu")
    for _ in range(3):
        ids = rng.integers(0, 2**40, 3000) if kind == "int" else rng.normal(size=3000).astype(np.float32)
        ref.update(jnp.asarray(ids))
        port.update(torch.from_numpy(ids))
        _equal(port.registers, ref.registers, "registers")
    np.testing.assert_allclose(_np(port.compute()), _np(ref.compute()), rtol=1e-6)
    assert port.fill_ratio() == ref.fill_ratio()


def test_heavy_hitters_grid_and_ties():
    """Every id once per update: every estimate ties, so the top-k is decided by the
    tie order alone (the lower sorted position first, as ``lax.top_k``)."""
    rng = np.random.default_rng(11)
    ref, port = js.HeavyHitters(k=8, depth=3, width=64), ts.HeavyHitters(k=8, depth=3, width=64, device="cpu")
    batches = [rng.permutation(64), rng.zipf(1.3, 64) % 500, np.arange(100, 164), rng.integers(0, 2**40, 64)]
    for ids in batches:
        w = rng.integers(1, 4, ids.shape[0])
        ref.update(jnp.asarray(ids), jnp.asarray(w))
        port.update(torch.from_numpy(ids), torch.from_numpy(w))
        _states_equal(port, ref, "hh")
    _equal(port.compute(), ref.compute(), "compute")
    assert port.fill_ratio() == ref.fill_ratio()
    cms = np.ones((2, 16), dtype=np.int64) * 3
    cands = np.array([9, 4, -1, 4, 7, 2, 9, 11, -1, 0], dtype=np.int64)
    _equal(
        tsk.merge_topk(torch.from_numpy(cms), torch.from_numpy(cands), 5, 2, 16),
        jsk.merge_topk(jnp.asarray(cms), jnp.asarray(cands), 5, 2, 16),
        "merge_topk ties",
    )


# ---------------------------------------------------------------- windows and decay


def _window_bases(port: bool):
    agg, cls = (ta, tc) if port else (ja, jc)
    kw = {"device": "cpu"} if port else {}
    return {
        "sum": lambda: agg.SumMetric(nan_strategy=0.0, **kw),
        "mean": lambda: agg.MeanMetric(nan_strategy=0.0, **kw),
        "max": lambda: agg.MaxMetric(nan_strategy=0.0, **kw),
        "accuracy": lambda: cls.MulticlassAccuracy(5, validate_args=False, **kw),
    }


def _window_batches(base: str, n: int = 9):
    rng = np.random.default_rng(len(base))
    if base == "accuracy":
        return [(rng.normal(size=(16, 5)).astype(np.float32), rng.integers(0, 5, 16)) for _ in range(n)]
    return [(_dyadic(rng, (12,)),) for _ in range(n)]


_WRAPPERS = {
    "window": (lambda pkg, b: pkg.WindowedMetric(b, buckets=3, bucket_size=2)),
    "decay": (lambda pkg, b: pkg.DecayedMetric(b, decay=0.5)),
}


@pytest.mark.parametrize("wrapper", sorted(_WRAPPERS))
@pytest.mark.parametrize("base", ["sum", "mean", "max", "accuracy"])
def test_streaming_three_levels(wrapper, base):
    """The per-batch ``forward`` value, the fold of two replicas and the epoch compute,
    over 9 updates (the 3 x 2 ring turns over)."""
    make = _WRAPPERS[wrapper]
    make_port = lambda: make(ts, _window_bases(True)[base]())  # noqa: E731
    make_ref = lambda: make(js, _window_bases(False)[base]())  # noqa: E731
    batches = _window_batches(base)
    atol = ACC_ATOL if base == "accuracy" else 0.0
    port, ref = make_port(), make_ref()
    for i, b in enumerate(batches):
        _equal(port(*map(torch.from_numpy, b)), ref(*map(jnp.asarray, b)), f"forward {i}", atol)
    _states_equal(port, ref, "states")
    _equal(port.compute(), ref.compute(), "compute", atol)
    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, b in enumerate(batches):
        (pa if i < 5 else pb).update(*map(torch.from_numpy, b))
        (ra if i < 5 else rb).update(*map(jnp.asarray, b))
    pa.merge_state(pb)
    ra.merge_state(rb)
    _states_equal(pa, ra, "merged")
    _equal(pa.compute(), ra.compute(), "merged compute", atol)


@pytest.mark.parametrize("base", ["sum", "accuracy"])
def test_window_engine_captures_one_signature(base):
    """With the engine on, the wrapper runs as one graph per step despite holding its
    base metric (the per-attribute exemption): one build, no fallback, and the states
    of the eager run."""
    batches = _window_batches(base)
    with engine_context(True):
        port = ts.WindowedMetric(_window_bases(True)[base](), buckets=3, bucket_size=2)
        for b in batches:
            port.update(*map(torch.from_numpy, b))
        st = port._engine.stats
        assert (st.traces, st.dispatches, st.eager_fallbacks) == (1, len(batches), 0)
    eager = ts.WindowedMetric(_window_bases(True)[base](), buckets=3, bucket_size=2)
    for b in batches:
        eager.update(*map(torch.from_numpy, b))
    _states_equal(port, eager, "engine vs eager")
    _equal(port.compute(), eager.compute(), "compute")


def test_nested_exemption_is_per_attribute():
    clean = ts.WindowedMetric(ta.SumMetric(nan_strategy=0.0, device="cpu"), buckets=2)
    assert not holds_nested_metrics(clean)
    dirty = ts.WindowedMetric(ta.SumMetric(nan_strategy=0.0, device="cpu"), buckets=2)
    dirty.sidekick = ta.SumMetric(nan_strategy=0.0, device="cpu")
    assert holds_nested_metrics(dirty)
    assert "base_metric" in clean._modules and "base_metric" not in clean.state_dict()


def _refusal_bases(port: bool):
    agg = ta if port else ja
    kw = {"device": "cpu"} if port else {}
    zero = (lambda: torch.tensor(0.0)) if port else (lambda: jnp.asarray(0.0))

    class MeanState(agg.SumMetric):
        def __init__(self):
            super().__init__(nan_strategy=0.0, **kw)
            self.add_state("avg", zero(), dist_reduce_fx="mean")

    class ZeroDefaultMax(agg.SumMetric):
        def __init__(self):
            super().__init__(nan_strategy=0.0, **kw)
            self.add_state("peak", zero(), dist_reduce_fx="max")

    return {"list": lambda: agg.CatMetric(nan_strategy=0.0, **kw), "mean": MeanState, "identity": ZeroDefaultMax}


@pytest.mark.parametrize("case", ["list", "mean", "identity"])
def test_check_streamable_refusals(case):
    """The refusals and their texts are the JAX package's."""
    with pytest.raises(JaxUserError) as want:
        js.WindowedMetric(_refusal_bases(False)[case](), buckets=2)
    with pytest.raises(TorchMetricsUserError) as got:
        ts.WindowedMetric(_refusal_bases(True)[case](), buckets=2)
    # the default's repr names its dtype: float64 in the JAX package's 64-bit mode
    assert re.sub(r"array\([^)]*\)", "array", str(got.value)) == re.sub(r"array\([^)]*\)", "array", str(want.value))


# ---------------------------------------------------------------- tenancy


def _tenancy_pair(template: str = "sum", capacity: int = 8):
    geom = dict(capacity=capacity, probes=4, spill_k=4, spill_depth=2, spill_width=16)
    if template == "sum":
        return (
            ts.TenantSlices(ta.SumMetric(nan_strategy=0.0, device="cpu"), **geom),
            js.TenantSlices(ja.SumMetric(nan_strategy=0.0), **geom),
        )
    return (
        ts.TenantSlices(tc.MulticlassAccuracy(4, average="macro", validate_args=False, device="cpu"), **geom),
        js.TenantSlices(jc.MulticlassAccuracy(4, average="macro", validate_args=False), **geom),
    )


def _tenant_stream(template: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, 24, n)
    ids[::7] = 2**33 + 5  # a wide id
    if template == "sum":
        return [(int(i), _dyadic(rng, (4,))) for i in ids]
    return [(int(i), rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 4, 8)) for i in ids]


@pytest.mark.parametrize("template, engine", [("sum", False), ("sum", True), ("accuracy", True)])
def test_tenancy_tables_past_capacity(template, engine):
    """Slot tables, counts, spill grids and top-k pairs equal past capacity, with
    negative and wide ids; with the engine on, one signature for every tenant."""
    port, ref = _tenancy_pair(template)
    stream = _tenant_stream(template, 60, 1)
    with engine_context(engine):
        for tid, *args in stream:
            port.update(torch.tensor(tid), *map(torch.from_numpy, args))
            ref.update(jnp.asarray(tid), *map(jnp.asarray, args))
    _states_equal(port, ref, "tenancy")
    if engine:
        assert (port._engine.stats.traces, port._engine.stats.eager_fallbacks) == (1, 0)
    _equal(port.compute(), ref.compute(), "global compute", ACC_ATOL if template == "accuracy" else 0.0)
    assert port.tenant_count() == ref.tenant_count() and port.spilled_count() == ref.spilled_count() > 0
    assert port.spill_report() == ref.spill_report()
    for tid in sorted({s[0] for s in stream}) + [999]:
        want = ref.tenant_value(tid)
        got = port.tenant_value(tid)
        assert (got is None) == (want is None), tid
        if want is not None:
            _equal(got, want, f"tenant {tid}", ACC_ATOL if template == "accuracy" else 0.0)
        assert port.tenant_updates(tid) == ref.tenant_updates(tid)


def test_federated_rollup():
    pods = [_tenancy_pair("sum", capacity=4) for _ in range(3)]
    for seed, (port, ref) in enumerate(pods):
        for tid, x in _tenant_stream("sum", 25, 10 + seed):
            port.update(torch.tensor(tid), torch.from_numpy(x))
            ref.update(jnp.asarray(tid), jnp.asarray(x))
    got = ts.federated_rollup([p for p, _ in pods])
    want = js.federated_rollup([r for _, r in pods])
    assert got["spilled_updates"] == want["spilled_updates"] and got["heavy_hitters"] == want["heavy_hitters"]
    assert list(got["tenants"]) == list(want["tenants"])
    for tid, row in want["tenants"].items():
        assert got["tenants"][tid]["updates"] == row["updates"]
        _equal(got["tenants"][tid]["value"], row["value"], f"tenant {tid}")


# ---------------------------------------------------------------- KLL


@pytest.mark.parametrize("sizes", [(64, 128), (37, 0, 100, 5), (0,)])
def test_kll_compactors_bit_equal(sizes):
    """Batches that are a multiple of k, ragged and empty: compactors, the geometric
    rider and every quantile view bit-equal."""
    rng = np.random.default_rng(sum(sizes))
    ref, port = js.KLLSketch(k=16, levels=8, qs=(0.5, 0.9, 0.99)), ts.KLLSketch(k=16, levels=8, qs=(0.5, 0.9, 0.99), device="cpu")
    for n in sizes:
        v = rng.lognormal(size=n).astype(np.float32)
        ref.update(jnp.asarray(v))
        port.update(torch.from_numpy(v))
        _states_equal(port, ref, f"after {n}")
    _equal(port.compute(), ref.compute(), "compute")
    for q in (0.1, 0.5, 1.0):
        _equal(port.quantile(q), ref.quantile(q), f"quantile {q}")
        _equal(port.coarse_quantile(q), ref.coarse_quantile(q), f"coarse {q}")
    total = sum(sizes)
    assert port.total_weight() == ref.total_weight() == total
    assert port.fill_ratio() == ref.fill_ratio()
    assert port.rank_error_bound(total) == ref.rank_error_bound(total)
    assert port.rank_error_bound(10**6) == ref.rank_error_bound(10**6) and port.growth_bound() == ref.growth_bound()


def test_kll_merge_of_stacked_sketches():
    rng = np.random.default_rng(21)
    states = []
    for i in range(3):
        m = js.KLLSketch(k=8, levels=6)
        m.update(jnp.asarray(rng.lognormal(size=40 + 13 * i).astype(np.float32)))
        states.append(np.asarray(m.compactors))
    stacked = np.stack(states)
    _equal(tq.kll_merge(torch.from_numpy(stacked)), jq.kll_merge(jnp.asarray(stacked)), "kll_merge")


# ---------------------------------------------------------------- snapshot-compute


def test_snapshot_compute_leaves_the_live_metric():
    m = ts.WindowedMetric(ta.SumMetric(nan_strategy=0.0, device="cpu"), buckets=2, bucket_size=1)
    for v in (1.0, 2.0, 3.0):
        m.update(torch.tensor(v))
    count, cache = m.update_count, m._computed
    assert float(m.snapshot_compute()) == float(m.compute()) == 5.0
    m.update(torch.tensor(10.0))
    assert float(m.snapshot_compute()) == 13.0 and m.update_count == count + 1
    assert m._computed is None and not m._is_synced and cache is None
    snap = ts.take_snapshot(m)
    m.update(torch.tensor(20.0))
    assert float(ts.snapshot_compute(m, snap)) == 13.0 and float(m.compute()) == 30.0


def test_collection_snapshot_compute():
    mc = MetricCollection({"s": ta.SumMetric(nan_strategy=0.0, device="cpu"), "m": ta.MeanMetric(nan_strategy=0.0, device="cpu")})
    mc.update(torch.tensor(4.0))
    mc.update(torch.tensor(6.0))
    assert {k: float(v) for k, v in mc.snapshot_compute().items()} == {"s": 10.0, "m": 5.0}
    assert {k: float(v) for k, v in mc.compute().items()} == {"s": 10.0, "m": 5.0}


#: snapshots the scrape thread must take while the loop updates back to back
SCRAPE_SNAPSHOTS = 24


@pytest.mark.parametrize("target", ["metric", "collection"])
def test_snapshot_against_a_back_to_back_loop(target, monkeypatch):
    """A scrape thread snapshots while the loop updates with no pause between updates,
    at the default retry budget: every snapshot succeeds and answers for one
    watermark. The windowed sum adds 1 per update, so its value is its watermark; the
    collection's step ``u`` adds ``u`` to a sum and a max, so a consistent copy has
    ``sum == max * (max + 1) / 2``."""
    import threading
    import time

    monkeypatch.delenv("TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES", raising=False)
    if target == "metric":
        m = ts.WindowedMetric(ta.SumMetric(nan_strategy=0.0, device="cpu"), buckets=4, bucket_size=1 << 20)
    else:
        m = MetricCollection({
            "s": ta.SumMetric(nan_strategy=0.0, device="cpu").set_dtype(torch.float64),
            "x": ta.MaxMetric(nan_strategy=0.0, device="cpu").set_dtype(torch.float64),
        }, compute_groups=False)  # one step's sum and max are equal: discovery would group them
    results, errors = [], []

    def scraper() -> None:
        try:
            while len(results) < SCRAPE_SNAPSHOTS:
                if target == "metric":
                    snap = ts.take_snapshot(m)
                    results.append((float(snap.update_count), float(ts.snapshot_compute(m, snap))))
                else:
                    values = m.snapshot_compute()
                    x = float(values["x"])
                    results.append((x * (x + 1) / 2, float(values["s"])))
        except BaseException as err:  # noqa: BLE001 -- reported to the loop thread
            errors.append(err)

    thread = threading.Thread(target=scraper, daemon=True)
    u, deadline = 1, time.monotonic() + 30.0
    m.update(torch.tensor(1.0, dtype=torch.float64))
    thread.start()
    while thread.is_alive() and time.monotonic() < deadline:
        u += 1
        m.update(torch.tensor(1.0 if target == "metric" else float(u), dtype=torch.float64))
    thread.join(30.0)
    assert not errors, errors
    assert len(results) == SCRAPE_SNAPSHOTS
    for expected, value in results:
        assert value == expected
    assert len({expected for expected, _ in results}) > 1  # the loop went on between snapshots


# ---------------------------------------------------------------- state carried from JAX


def _carry_cases():
    return {
        "window": (
            lambda: js.WindowedMetric(jc.MulticlassAccuracy(4, validate_args=False), buckets=3, bucket_size=2),
            lambda: ts.WindowedMetric(tc.MulticlassAccuracy(4, validate_args=False, device="cpu"), buckets=3, bucket_size=2),
            lambda rng: (rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 4, 8)),
        ),
        "tenancy": (
            lambda: js.TenantSlices(ja.SumMetric(nan_strategy=0.0), capacity=4, probes=2, spill_k=4, spill_depth=2, spill_width=16),
            lambda: ts.TenantSlices(ta.SumMetric(nan_strategy=0.0, device="cpu"), capacity=4, probes=2, spill_k=4, spill_depth=2, spill_width=16),
            lambda rng: (np.asarray(int(rng.integers(0, 2**40))), _dyadic(rng, (4,))),
        ),
        "kll": (
            lambda: js.KLLSketch(k=8, levels=6),
            lambda: ts.KLLSketch(k=8, levels=6, device="cpu"),
            lambda rng: (rng.lognormal(size=21).astype(np.float32),),
        ),
        "hh": (
            lambda: js.HeavyHitters(k=4, depth=2, width=16),
            lambda: ts.HeavyHitters(k=4, depth=2, width=16, device="cpu"),
            lambda rng: (rng.integers(0, 2**40, 30),),
        ),
    }


@pytest.mark.parametrize("case", ["window", "tenancy", "kll", "hh"])
def test_state_carried_from_jax(case):
    """Updates in the JAX package, the state through ``state_from_jax`` (integer states
    at the port metric's dtypes, wide ids and ``+inf`` pads intact), then more updates
    on both sides: equal states."""
    make_ref, make_port, batch = _carry_cases()[case]
    rng = np.random.default_rng(31)
    ref, port = make_ref(), make_port()
    ref.persistent(True)
    for _ in range(7):
        ref.update(*map(jnp.asarray, batch(rng)))
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu", metric=port))
    assert port.update_count == 7
    for attr in port._defaults:
        assert getattr(port, attr).dtype == port._defaults[attr].dtype, attr
    for _ in range(4):
        b = batch(rng)
        ref.update(*map(jnp.asarray, b))
        port.update(*map(torch.from_numpy, b))
    _states_equal(port, ref, case)
    _equal(port.compute(), ref.compute(), "compute", ACC_ATOL if case == "window" else 0.0)


def test_state_carry_rejects_an_over_range_count():
    """A count past the port default's dtype raises with ``metric=`` too, as without it;
    an id past ``2**32`` fits the tenant table's int64 and carries."""
    ref = js.WindowedMetric(jc.MulticlassAccuracy(4, validate_args=False), buckets=3, bucket_size=2)
    port = ts.WindowedMetric(tc.MulticlassAccuracy(4, validate_args=False, device="cpu"), buckets=3, bucket_size=2)
    ref.persistent(True)
    ref.update(jnp.zeros((2, 4), jnp.float32), jnp.zeros(2, jnp.int32))
    state = ref.state_dict()
    key = next(k for k in state if k in port._defaults and port._defaults[k].dtype == torch.int32)
    state[key] = np.full(np.shape(state[key]), 2**31, dtype=np.int64)
    with pytest.raises(ValueError, match="does not fit torch.int32"):
        state_from_jax(state, "cpu", metric=port)
    with pytest.raises(ValueError, match="does not fit torch.int32"):
        state_from_jax(state, "cpu")
    tenants = ts.TenantSlices(ta.SumMetric(nan_strategy=0.0, device="cpu"), capacity=4)
    carried = state_from_jax({"tenant_ids": np.full(5, 2**40, dtype=np.int64)}, "cpu", metric=tenants)
    assert carried["tenant_ids"].dtype == torch.int64 and int(carried["tenant_ids"][0]) == 2**40


def test_snapshot_holder_mutates_without_waiting():
    """A thread that holds a metric's updates off (a snapshot in progress) still runs
    its own mutations of it at once: the gate waits only for other threads."""
    import time

    from torchmetrics_tpu_torch.metric import quiesced

    m = ta.SumMetric(nan_strategy=0.0, device="cpu")
    t0 = time.monotonic()
    with quiesced(m, 1.0) as quiet:
        assert quiet
        m.update(torch.tensor(2.0))
    assert time.monotonic() - t0 < 1.0 and float(m.compute()) == 2.0
    assert m._gate is None and m._mutation_depth == 0
