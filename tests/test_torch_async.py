"""The port's background drains (``torchmetrics_tpu_torch/engine/async_dispatch.py``)
against the JAX package's (``torchmetrics_tpu/engine/async_dispatch.py``) and against
the port's own synchronous scan, on the CPU.

On the CPU the worker runs the same masked step body a drain runs on the caller (under
the queue lock: it swaps the metric's states while it runs), so the states must be
bit-equal to the synchronous scan's and to the eager run's, and equal to the JAX
package's (integer states exactly, float states within relative 1e-6). The first drain
of each (ring, ``kb``) pair runs on the caller; later ones ride the worker.
"""

from __future__ import annotations

import threading
import time

import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from tests.torch_parity import assert_same_states, config2_members, tier_batches, to_jax, to_port
from torchmetrics_tpu.engine import async_dispatch as jax_async
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.engine.scan import scan_context as jax_scan_context
from torchmetrics_tpu_torch.engine import async_dispatch, engine_context, scan
from torchmetrics_tpu_torch.engine.async_dispatch import MAX_INFLIGHT, async_context, coerce_inflight
from torchmetrics_tpu_torch.engine.scan import scan_context
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

C = 5
N = 24


def _metric(side: str, kind: str = "accuracy", **kw):
    pkg = tm if side == "port" else jtm.classification
    dev = {"device": "cpu"} if side == "port" else {}
    if kind == "accuracy":
        return pkg.MulticlassAccuracy(C, average="macro", validate_args=False, **dev, **kw)
    return pkg.MulticlassConfusionMatrix(C, validate_args=False, **dev, **kw)


def _run(kind: str, batches, k=None, inflight=None, observe_every: int = 0):
    with engine_context(True):
        m = _metric("port", kind, scan_steps=k, async_dispatch=inflight)
        seen = []
        for i, b in enumerate(batches, 1):
            m.update(*to_port(b))
            if observe_every and i % observe_every == 0:
                seen.append(m.compute().clone())
        m._drain_scan("test")
    return m, seen


def _eager(kind: str, batches):
    m = _metric("port", kind)
    for b in batches:
        m.update(*to_port(b))
    return m


# ---------------------------------------------------------------- knobs


@pytest.mark.parametrize("value", [None, 0, False, True, 1, 2, MAX_INFLIGHT])
def test_coerce_inflight_accepts_the_jax_values(value):
    assert coerce_inflight(value) == jax_async.coerce_inflight(value)


@pytest.mark.parametrize("value", [-1, MAX_INFLIGHT + 1, 1.5, "2"])
def test_coerce_inflight_raises_as_jax_does(value):
    with pytest.raises(Exception) as jax_err:
        jax_async.coerce_inflight(value)
    with pytest.raises(TorchMetricsUserError) as port_err:
        coerce_inflight(value)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("raw", ["", "0", "off", "1", "on", "2", "16", "17", "banana", "-2"])
def test_env_var_resolves_as_jax(monkeypatch, raw):
    monkeypatch.setenv("TORCHMETRICS_TPU_ASYNC", raw)
    try:
        want = jax_async.async_inflight()
    except Exception as err:  # noqa: BLE001
        with pytest.raises(TorchMetricsUserError) as port_err:
            async_dispatch.async_inflight()
        assert str(port_err.value) == str(err)
        return
    assert async_dispatch.async_inflight() == want


def test_the_knob_is_inert_without_scan(monkeypatch):
    """As in the JAX package: an invalid ``TORCHMETRICS_TPU_ASYNC`` is read only where a
    scan queue is active."""
    monkeypatch.setenv("TORCHMETRICS_TPU_ASYNC", "banana")
    batch = to_port(tier_batches([16])[0])
    with engine_context(True):
        m = _metric("port")
        m.update(*batch)  # no scan queue: never read
        assert m._engine._scan is None
        queued = _metric("port", scan_steps=4)
        with pytest.raises(TorchMetricsUserError, match="TORCHMETRICS_TPU_ASYNC"):
            queued.update(*batch)
    with jax_engine_context(True, donate=True):
        ref = _metric("jax")
        ref.update(*to_jax(tier_batches([16])[0]))
        ref_q = _metric("jax", scan_steps=4)
        with pytest.raises(Exception, match="TORCHMETRICS_TPU_ASYNC"):
            ref_q.update(*to_jax(tier_batches([16])[0]))


# ---------------------------------------------------------------- background drains


@pytest.mark.parametrize("kind", ["accuracy", "confmat"])
@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("k", [2, 4])
def test_background_drains_equal_the_synchronous_scan(kind, inflight, k):
    batches = tier_batches([32] * (N - 3) + [20, 32, 7], seed=k + inflight)
    port, _ = _run(kind, batches, k=k, inflight=inflight)
    sync, _ = _run(kind, batches, k=k)
    st = port._engine.stats
    assert st.async_dispatches > 0 and st.async_submits == st.async_dispatches
    assert st.scan_steps_folded == len(batches) and st.async_replayed_steps == 0
    assert st.scan_steps_folded == sync._engine.stats.scan_steps_folded
    assert_same_states(port, sync)
    assert_same_states(port, _eager(kind, batches))
    with jax_engine_context(True, donate=True), jax_scan_context(k), jax_async.async_context(inflight):
        ref = _metric("jax", kind)
        for b in batches:
            ref.update(*to_jax(b))
        ref._drain_scan("test")
    assert_same_states(port, ref)


def test_every_observation_joins():
    batches = tier_batches([32] * N, seed=3)
    port, seen = _run("accuracy", batches, k=4, inflight=2, observe_every=5)
    for i, value in enumerate(seen, 1):
        assert torch.equal(value, _eager("accuracy", batches[: 5 * i]).compute())
    assert port._engine.stats.async_joins >= 1 or port._engine.stats.async_dispatches == 0


def _slow_worker(monkeypatch, delay: float = 0.02):
    """A worker that takes ``delay`` before each drain (outside the queue lock, which its
    CPU body holds)."""
    real = scan._ScanQueue.worker_execute

    def slow(self, work):
        time.sleep(delay)
        return real(self, work)

    monkeypatch.setattr(scan._ScanQueue, "worker_execute", slow)


@pytest.mark.parametrize("inflight", [1, 2])
def test_backpressure_bounds_the_buffers_in_flight(monkeypatch, inflight):
    batches = tier_batches([32] * N, seed=4)
    _slow_worker(monkeypatch)
    port, _ = _run("accuracy", batches, k=2, inflight=inflight)
    st = port._engine.stats
    assert st.async_backpressure_waits > 0
    assert_same_states(port, _eager("accuracy", batches))
    # rings: at most inflight + 1 per signature
    (plan,) = port._engine._scan._plans.values()
    assert len(plan.rings) <= inflight + 1


def test_a_failed_worker_drain_replays_in_order_at_the_next_join(monkeypatch):
    batches = tier_batches([32] * N, seed=5)
    real = scan._Plan.body
    failed = {"n": 0}

    def flaky(self, ring, kb):
        if threading.current_thread().name.startswith("tm-torch-async") and failed["n"] == 0:
            failed["n"] += 1
            raise RuntimeError("planted worker failure")
        return real(self, ring, kb)

    monkeypatch.setattr(scan._Plan, "body", flaky)
    port, _ = _run("confmat", batches, k=4, inflight=2)
    st = port._engine.stats
    assert failed["n"] == 1
    assert st.async_replayed_steps > 0
    assert st.fallback_reasons["scan-async-failed:RuntimeError"] == 1
    assert st.scan_steps_folded + st.async_replayed_steps == len(batches)
    assert_same_states(port, _eager("confmat", batches))


def test_async_context_exit_joins():
    batches = tier_batches([32] * 9, seed=6)
    with engine_context(True), scan_context(4):
        with async_context(2):
            m = _metric("port")
            for b in batches:
                m.update(*to_port(b))
        assert m._engine._scan.pending == 0
    assert m._engine.stats.scan_flush_reasons["async-scope-exit"] == 1
    assert_same_states(m, _eager("accuracy", batches))


@pytest.mark.parametrize("inflight", [1, 2])
def test_config2_collection_with_background_drains(inflight):
    batches = tier_batches([32] * 12, seed=7)
    with engine_context(True):
        port = tm.MetricCollection(config2_members(True), scan_steps=4, async_dispatch=inflight)
        for b in batches:
            port.update(*to_port(b))
        out = port.compute()
        assert port._fused_engine.stats.async_dispatches > 0
    eager = tm.MetricCollection(config2_members(True))
    for b in batches:
        eager.update(*to_port(b))
    ref_out = eager.compute()
    for name in ("stats", "acc", "acc_w", "auroc", "confmat", "confmat_t"):
        assert_same_states(port[name], eager[name])
        assert torch.equal(torch.as_tensor(out[name]), torch.as_tensor(ref_out[name]))
