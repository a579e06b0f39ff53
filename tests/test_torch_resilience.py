"""The fault-tolerant sync (``parallel/resilience.py``, ``parallel/faults.py``, the
degraded re-plan in ``engine/epoch.py``), held against the JAX package.

- One process fakes a world of 2 on both sides, every rank holding this process's
  state: the JAX side as ``tests/test_faults.py`` does (``jax.process_count`` and
  ``process_allgather`` patched), the port by patching ``parallel/sync.py``'s
  ``distributed_available``, ``world_size`` and ``raw_all_gather``. Every scenario of
  ``tests/test_faults.py`` that needs no telemetry runs through both packages, which
  must give the same typed error (class, ``attempts``, ``retryable``, ``rank``), the
  same ``resilience_snapshot()`` counts and ``sync_retries`` / ``sync_degraded_folds``,
  the same flight-recorder events in order (each collective, retry, fault and degraded
  re-plan), and the same values (integers
  exactly, floats to 1e-6). The JAX side runs in 32-bit mode, the port's dtypes.
- The environment parses alike in both packages; ``bounded_pull`` classifies a
  transport error and retries an in-flight timeout alike; the payload crc32 of the
  port equals the JAX digest of the same bytes.
- Two gloo processes: a planted ``RankDrop`` folds over rank 0's states on both ranks,
  a ``DelayRank`` past a 100 ms deadline raises naming the rank, and with no policy the
  packed compute issues the collectives it issued before (one per buffer plus the
  metadata gather).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.parallel as jp
from tests.test_torch_sync_guard import run_two_ranks
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu.diag import diag_context as jax_diag_context
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.engine.stats import reset_engine_stats as jax_reset
from torchmetrics_tpu.parallel import resilience as jres
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.parallel as tp
from torchmetrics_tpu_torch import MetricCollection as TorchCollection
from torchmetrics_tpu_torch.diag import diag_context as torch_diag_context
from torchmetrics_tpu_torch.engine import engine_context as torch_engine_context
from torchmetrics_tpu_torch.engine.stats import reset_engine_stats as torch_reset
from torchmetrics_tpu_torch.parallel import faults as tfaults
from torchmetrics_tpu_torch.parallel import resilience as tres
from torchmetrics_tpu_torch.parallel import sync as tsync

NUM_CLASSES = 5
SIDES = ("jax", "port")
#: the events both packages record at the bounded-collective boundary
FAULT_EVENTS = ("collective", "sync.retry", "sync.fault", "sync.degraded")


class _Side:
    """One package's names, so each scenario is written once."""

    def __init__(self, name: str):
        self.name = name
        jax_side = name == "jax"
        self.P = jp if jax_side else tp
        self.res = jres if jax_side else tres
        self.cls = jc if jax_side else tc
        self.collection = JaxCollection if jax_side else TorchCollection
        self.diag_context = jax_diag_context if jax_side else torch_diag_context
        self.engine_context = jax_engine_context if jax_side else torch_engine_context
        self.reset = jax_reset if jax_side else torch_reset
        self.kw = {} if jax_side else {"device": "cpu"}

    def array(self, x: np.ndarray):
        return jnp.asarray(x) if self.name == "jax" else torch.from_numpy(np.ascontiguousarray(x))

    def metric(self, **kw):
        m = self.cls.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, **self.kw, **kw)
        m.distributed_available_fn = lambda: True
        return m

    def batch(self, seed: int = 0, n: int = 16):
        rng = np.random.RandomState(seed)
        return self.array(rng.rand(n, NUM_CLASSES).astype(np.float32)), self.array(rng.randint(0, NUM_CLASSES, n).astype(np.int32))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextmanager
def world(side: _Side, monkeypatch, gather=None, size: int = 2):
    """A world of ``size`` in one process: every rank holds this process's state
    (``gather`` replaces the raw collective, taking the tensor as it is handed in)."""
    if side.name == "jax":
        from jax.experimental import multihost_utils

        monkeypatch.setattr(jax, "process_count", lambda: size)
        raw = gather or (lambda x: np.stack([np.asarray(x)] * size))
        monkeypatch.setattr(multihost_utils, "process_allgather", lambda x, tiled=False: raw(x))
        with jax.enable_x64(False):
            yield
    else:
        monkeypatch.setattr(tsync, "distributed_available", lambda: True)
        monkeypatch.setattr(tsync, "world_size", lambda group=None: size)
        raw = gather or (lambda x: [x.clone() for _ in range(size)])
        monkeypatch.setattr(tsync, "raw_all_gather", lambda x, group=None: raw(x))
        yield


def _outcome(side: _Side, fn) -> dict:
    """Run ``fn()`` from zeroed counters: its value or typed error, the resilience
    counts and the fault events, as plain data."""
    side.reset()
    out: dict = {}
    with side.diag_context() as rec:
        try:
            out["value"] = fn()
        except side.res.SyncFaultError as err:
            out["error"] = (type(err).__name__, err.attempts, err.retryable, err.rank, err.label)
    out["counts"] = side.res.resilience_snapshot()["counts"]
    out["events"] = [(e.kind, e.data.get("label"), e.data.get("rank")) for e in rec.snapshot() if e.kind in FAULT_EVENTS]
    side.reset()
    return out


def _same(outcomes: dict) -> dict:
    """Both packages' outcomes agree; returns the port's."""
    jax_out, port_out = outcomes["jax"], outcomes["port"]
    for key in ("error", "counts", "events"):
        assert jax_out.get(key) == port_out.get(key), (key, jax_out.get(key), port_out.get(key))
    assert ("value" in jax_out) == ("value" in port_out)
    if "value" in jax_out:
        jv, pv = jax_out["value"], port_out["value"]
        if isinstance(jv, dict):
            assert jv.keys() == pv.keys()
            for k in jv:
                _close(jv[k], pv[k])
        else:
            _close(jv, pv)
    return port_out


def _close(a, b) -> None:
    if isinstance(a, str):
        assert a == b
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    a, b = np.asarray(_np(a)), np.asarray(_np(b))
    if a.dtype.kind in "iub" and b.dtype.kind in "iub":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def both(monkeypatch, scenario, gather=None) -> dict:
    outcomes = {}
    for name in SIDES:
        side = _Side(name)
        with monkeypatch.context() as mp, world(side, mp, gather=None if gather is None else gather(side)):
            outcomes[name] = _outcome(side, lambda: scenario(side))
    return _same(outcomes)


# ------------------------------------------------------------------ the harness


def test_fault_due_is_deterministic_and_bounded_like_jax():
    seen = {}
    for side in map(_Side, SIDES):
        f = side.P.CollectiveTimeout(label="reduce:*", times=2, after=1)
        calls = ["meta", "reduce:int32", "reduce:int32", "reduce:float32", "reduce:int32"]
        seen[side.name] = ([f.due(c, None) for c in calls], f.fired)
    assert seen["jax"] == seen["port"] == ([False, False, True, True, False], 2)


def test_rank_scoped_fault_respects_membership_like_jax():
    seen = {}
    for side in map(_Side, SIDES):
        f = side.P.RankDrop(rank=1)
        seen[side.name] = [f.due("reduce:int32", (0, 1)), f.due("reduce:int32", (0,)), f.due("reduce:int32", None)]
        with pytest.raises(ValueError, match="requires a target rank"):
            side.P.DelayRank(rank=None, delay_ms=5)
    assert seen["jax"] == seen["port"] == [True, False, True]


def test_fault_context_scopes_and_restores():
    assert tfaults.active_faults() == ()
    with tp.fault_context(tp.CollectiveTimeout()) as planted:
        assert tfaults.active_faults() == planted
    assert tfaults.active_faults() == ()
    with pytest.raises(TypeError):
        with tp.fault_context("not a fault"):
            pass


# ------------------------------------------------------------------ the policy


ENV_CASES = [
    {"TORCHMETRICS_TPU_SYNC_DEADLINE_MS": "1500", "TORCHMETRICS_TPU_SYNC_RETRIES": "5",
     "TORCHMETRICS_TPU_SYNC_BACKOFF_MS": "10", "TORCHMETRICS_TPU_DEGRADED": "0"},
    {},
    {"TORCHMETRICS_TPU_SYNC_DEADLINE_MS": "0", "TORCHMETRICS_TPU_SYNC_RETRIES": "-3"},
    {"TORCHMETRICS_TPU_SYNC_DEADLINE_MS": "soon", "TORCHMETRICS_TPU_SYNC_RETRIES": "two",
     "TORCHMETRICS_TPU_SYNC_BACKOFF_MS": " 2.5 ", "TORCHMETRICS_TPU_DEGRADED": "1"},
    {"TORCHMETRICS_TPU_SYNC_RETRIES": "1.9", "TORCHMETRICS_TPU_SYNC_BACKOFF_MS": "-4"},
]


@pytest.mark.parametrize("env", ENV_CASES)
def test_policy_env_parses_alike(monkeypatch, env):
    for var in (tres.DEADLINE_ENV_VAR, tres.RETRIES_ENV_VAR, tres.BACKOFF_ENV_VAR, tres.DEGRADED_ENV_VAR):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    seen = {}
    for side in map(_Side, SIDES):
        p = side.res.current_policy()
        seen[side.name] = (p.deadline_ms, p.retries, p.backoff_ms, p.degraded, p.verify_payload)
        seen[side.name + ":snapshot"] = {k: v for k, v in side.res.resilience_snapshot().items() if k != "counts"}
    assert seen["jax"] == seen["port"], seen
    assert seen["jax:snapshot"] == seen["port:snapshot"]


def test_resilience_context_overrides_env(monkeypatch):
    monkeypatch.setenv(tres.DEADLINE_ENV_VAR, "1500")
    with tp.resilience_context(deadline_ms=50, retries=0) as policy:
        assert tres.current_policy() is policy
        assert policy.deadline_ms == 50.0
    assert tres.current_policy().deadline_ms == 1500.0


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64, np.bool_, np.uint8, np.float64])
def test_payload_crc_equals_jax_digest(dtype):
    rng = np.random.default_rng(7)
    for shape in [(), (5,), (3, 4)]:
        x = (rng.standard_normal(shape) * 100).astype(dtype)
        assert tres._payload_crc(torch.from_numpy(np.array(x))) == jres._payload_crc(x)


# ------------------------------------------------------------------ the eager path


def _hanging(side, calls=None):
    def gather(x):
        if calls is not None:
            calls.append(1)
        time.sleep(3.0)
        return np.stack([np.asarray(x)] * 2) if side.name == "jax" else [x, x]

    return gather


def test_deadline_escapes_hanging_collective(monkeypatch):
    seen = {}
    for side in map(_Side, SIDES):
        calls: list = []
        with monkeypatch.context() as mp, world(side, mp, gather=_hanging(side, calls)):

            def scenario():
                t0 = time.perf_counter()
                with side.P.resilience_context(deadline_ms=100, retries=5, backoff_ms=1):
                    side.P.gather_all_tensors(side.array(np.ones(3, np.float32)))
                return time.perf_counter() - t0

            seen[side.name] = out = _outcome(side, scenario)
        assert out["error"][0] == "CollectiveTimeoutError" and len(calls) == 1, out
    _same(seen)
    # one deadline, not six: the in-flight escape is never retried
    assert seen["port"]["error"] == ("CollectiveTimeoutError", 1, False, None, "eager:shape")


def test_env_deadline_alone_bounds_the_eager_gather(monkeypatch):
    monkeypatch.setenv(tres.DEADLINE_ENV_VAR, "100")
    monkeypatch.setenv(tres.RETRIES_ENV_VAR, "0")
    side = _Side("port")
    with world(side, monkeypatch, gather=_hanging(side)):
        t0 = time.perf_counter()
        with pytest.raises(tp.CollectiveTimeoutError) as err:
            tp.gather_all_tensors(torch.ones(2, 2))
    assert time.perf_counter() - t0 < 2.0 and err.value.in_flight


@pytest.mark.parametrize(
    ("faults", "policy"),
    [
        (lambda P: [P.CollectiveTimeout(label="eager:state", times=1)], dict(retries=1, backoff_ms=1)),
        (lambda P: [P.CollectiveTimeout(times=None)], dict(retries=1, backoff_ms=1)),
        (lambda P: [P.RankDrop(rank=1)], dict(retries=5, backoff_ms=1)),
        (lambda P: [P.CorruptPayload(rank=0, times=1)], dict(retries=2, backoff_ms=1, verify_payload=True)),
        (lambda P: [P.CorruptPayload(rank=0, times=None)], dict(retries=1, backoff_ms=1, verify_payload=True)),
        (lambda P: [P.DelayRank(rank=1, delay_ms=30, times=None)], dict(deadline_ms=10, retries=0)),
        (lambda P: [], dict(retries=2, verify_payload=True)),
    ],
    ids=["timeout-retried", "timeout-exhausted", "rank-drop", "corrupt-retried", "corrupt-exhausted", "delay", "clean"],
)
def test_eager_gather_faults_like_jax(monkeypatch, faults, policy):
    def scenario(side):
        with side.P.resilience_context(**policy), side.P.fault_context(*faults(side.P)):
            out = side.P.gather_all_tensors(side.array(np.arange(4.0, dtype=np.float32)))
        return [_np(o) for o in out]

    out = both(monkeypatch, scenario)
    if "value" in out:
        assert len(out["value"]) == 2
        np.testing.assert_array_equal(out["value"][0], np.arange(4.0))


def test_rank_drop_never_enters_the_collective(monkeypatch):
    side = _Side("port")
    calls: list = []
    with world(side, monkeypatch, gather=lambda x: calls.append(1) or [x, x]):
        with tp.resilience_context(retries=5, backoff_ms=1), tp.fault_context(tp.RankDrop(rank=1)):
            with pytest.raises(tp.RankUnreachableError) as err:
                tp.gather_all_tensors(torch.arange(4.0))
    assert err.value.rank == 1 and calls == []


# ------------------------------------------------------------------ the packed path


def _packed(side, seed, faults=(), **policy):
    preds, target = side.batch(seed)
    with side.engine_context(True), side.P.resilience_context(**policy), side.P.fault_context(*faults):
        m = side.metric()
        m.update(preds, target)
        value = m.compute()
    st = m._epoch.stats
    return {"value": _np(value), "retries": st.sync_retries, "degraded": st.sync_degraded_folds}


@pytest.mark.parametrize(
    ("faults", "policy", "degraded"),
    [
        (lambda P: [P.CollectiveTimeout(times=1)], dict(retries=2, backoff_ms=1), 0),
        (lambda P: [P.RankDrop(rank=1)], dict(retries=0, backoff_ms=1), 1),
        (lambda P: [P.RankDrop(rank=1)], dict(retries=0, degraded=False), None),
        # the survivors' collective runs under the watchdog too: a deadline with room for
        # a loaded machine's thread start
        (lambda P: [P.DelayRank(rank=1, delay_ms=400, times=None)], dict(deadline_ms=200, retries=0, backoff_ms=1), 1),
        (lambda P: [P.RankDrop(rank=1), P.RankDrop(rank=0)], dict(retries=0, backoff_ms=1), None),
        (lambda P: [P.CorruptPayload(rank=0, times=1)], dict(retries=2, backoff_ms=1, verify_payload=True), 0),
        (lambda P: [], dict(), 0),
    ],
    ids=["timeout-recovers", "rank-drop-degrades", "degraded-off", "delay-names-rank", "both-dead", "corrupt", "clean"],
)
def test_packed_sync_faults_like_jax(monkeypatch, faults, policy, degraded):
    out = both(monkeypatch, lambda side: _packed(side, 3, faults(side.P), **policy))
    assert ("value" in out) == (degraded is not None), out
    if degraded is None:
        return
    assert out["value"]["degraded"] == degraded
    # the identical-rank world's fold (a survivor's or the full world's) is the local compute
    side = _Side("port")
    local = side.metric(compiled_update=False)
    local.distributed_available_fn = lambda: False
    local.update(*side.batch(3))
    np.testing.assert_allclose(out["value"]["value"], _np(local.compute()), rtol=1e-6)


def test_degraded_event_names_the_survivors(monkeypatch):
    side = _Side("port")
    with world(side, monkeypatch):
        with tp.resilience_context(retries=0, backoff_ms=1), torch_diag_context() as rec:
            with tp.fault_context(tp.RankDrop(rank=1)):
                _packed(side, 1, retries=0, backoff_ms=1)
    degraded = [e for e in rec.snapshot() if e.kind == "sync.degraded"]
    assert len(degraded) == 1 and degraded[0].data["rank"] == 1 and degraded[0].data["survivors"] == (0,)
    assert degraded[0].data["error"] == "RankUnreachableError"


def test_degraded_plan_is_membership_keyed(monkeypatch):
    """A degraded fold never reuses the full world's entry: the plan signature carries
    the membership, so the fused cache gains one entry (JAX: one more fold trace)."""
    grown = {}
    for side in map(_Side, SIDES):
        with monkeypatch.context() as mp, world(side, mp):
            preds, target = side.batch(4)
            with side.engine_context(True), side.P.resilience_context(retries=0, backoff_ms=1):
                m = side.metric()
                m.update(preds, target)
                m.compute()
                size = lambda: m._epoch.stats.sync_fold_traces if side.name == "jax" else len(m._epoch._fused_cache)  # noqa: E731
                before = size()
                m.reset()
                m.update(preds, target)
                with side.P.fault_context(side.P.RankDrop(rank=1)):
                    m.compute()
                grown[side.name] = (size() - before, m._epoch.stats.sync_degraded_folds)
    assert grown["jax"] == grown["port"] == (1, 1)


def test_collection_degrades_once_for_all_owners(monkeypatch):
    def scenario(side):
        preds, target = side.batch(5)
        build = lambda: {  # noqa: E731
            "acc": side.cls.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, **side.kw),
            "cm": side.cls.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, **side.kw),
        }
        with side.engine_context(True), side.P.resilience_context(retries=0, backoff_ms=1), side.P.fault_context(
            side.P.RankDrop(rank=1)
        ):
            mc = side.collection(build(), compute_groups=True, fused_dispatch=True)
            for m in mc._modules.values():
                m.distributed_available_fn = lambda: True
            mc.update(preds, target)
            got = {k: _np(v) for k, v in mc.compute().items()}
        assert mc._epoch_sync.stats.sync_degraded_folds == 1
        return got

    out = both(monkeypatch, scenario)
    # the survivor fold of the identical-rank world is the local compute
    side = _Side("port")
    local = {"acc": side.metric(compiled_update=False), "cm": tc.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device="cpu")}
    for m in local.values():
        m.update(*side.batch(5))
    for k, m in local.items():
        _close(out["value"][k], m.compute())


def test_clean_run_has_zero_fault_counters(monkeypatch):
    side = _Side("port")
    with world(side, monkeypatch):
        out = _outcome(side, lambda: _packed(side, 6))
    assert out["counts"] == {} and out["events"] == [("collective", "reduce:int32", None)]
    assert (out["value"]["retries"], out["value"]["degraded"]) == (0, 0)


def test_straggler_hint_is_consumed_once():
    tres.note_straggler(3)
    assert tres.last_straggler_rank() == 3
    assert tres.consume_straggler_hint() == 3
    assert tres.consume_straggler_hint() is None


def test_no_policy_wrapper_calls_the_collective_directly(monkeypatch):
    """No deadline, no verify_payload, no fault: the raw gather is called once with the
    payload itself, on the caller's thread."""
    import threading

    side = _Side("port")
    seen = []

    def gather(x):
        seen.append((x.dtype, tuple(x.shape), threading.current_thread() is threading.main_thread()))
        return [x.clone(), x.clone()]

    with world(side, monkeypatch, gather=gather):
        tp.gather_all_tensors(torch.arange(6.0).reshape(2, 3))
    assert seen == [(torch.int64, (2,), True), (torch.float32, (2, 3), True)]


# ------------------------------------------------------------------ bounded_pull


def _pull_outcome(side, fetch, **policy) -> dict:
    def run():
        with side.P.resilience_context(**policy):
            return side.res.bounded_pull(fetch, label="fleet-pull:pod3", rank=3)

    return _outcome(side, run)


def test_bounded_pull_classifies_transport_errors_like_jax():
    seen = {}
    for side in map(_Side, SIDES):

        def fetch():
            raise ConnectionRefusedError("pod down")

        seen[side.name] = _pull_outcome(side, fetch, retries=3, backoff_ms=1)
    out = _same(seen)
    assert out["error"] == ("RankUnreachableError", 1, False, 3, "fleet-pull:pod3")


def test_bounded_pull_retries_an_in_flight_timeout_like_jax():
    seen = {}
    for side in map(_Side, SIDES):
        calls: list = []

        def fetch():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(2.0)
            return "ok"

        seen[side.name] = _pull_outcome(side, fetch, deadline_ms=500, retries=2, backoff_ms=1)
    out = _same(seen)
    assert out["value"] == "ok" and out["counts"] == {"fault:CollectiveTimeoutError": 1, "retries": 1}


# ------------------------------------------------------------------ two gloo ranks

_TWO_RANKS = """
import sys
import numpy as np
import torch
import torchmetrics_tpu_torch.parallel as tp
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.diag import diag_context
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

def members():
    return {
        "acc": MulticlassAccuracy(num_classes=4, device="cpu"),
        "auroc": MulticlassAUROC(num_classes=4, thresholds=9, device="cpu"),
        "auroc_exact": MulticlassAUROC(num_classes=4, device="cpu"),
        "cm": MulticlassConfusionMatrix(num_classes=4, device="cpu"),
    }

def collection(rank):
    rng = np.random.default_rng(300 + rank)
    mc = MetricCollection(members())
    for _ in range(2 + rank):
        p = rng.random((12, 4)).astype(np.float32)
        mc.update(torch.from_numpy(p / p.sum(1, keepdims=True)), torch.from_numpy(rng.integers(0, 4, 12)))
    return mc

def run(rank):
    out = {}
    mc = collection(rank)
    mc.persistent(True)
    torch.save(mc.state_dict(), f"{sys.argv[1]}/local{rank}.pt")
    plan = PackedSyncPlan([(g.owner, mc._modules[g.owner]) for g in mc._groups.values()], 2)
    meta = plan.metadata_local()
    plan.finalize(None if meta is None else np.stack([meta, meta]))
    values = mc.compute()
    st = mc._epoch_sync.stats
    out["clean"] = {"sync_collectives": st.sync_collectives, "buffers": len(plan.buffer_keys()),
                    "rank_invariant": plan.rank_invariant, "retries": st.sync_retries, "degraded": st.sync_degraded_folds}

    mc = collection(rank)
    with tp.resilience_context(retries=0, backoff_ms=1), tp.fault_context(tp.RankDrop(rank=1)), diag_context() as rec:
        values = mc.compute()
    st = mc._epoch_sync.stats
    torch.save(values, f"{sys.argv[1]}/degraded{rank}.pt")
    out["drop"] = {"degraded": st.sync_degraded_folds, "retries": st.sync_retries,
                   "survivors": [list(e.data["survivors"]) for e in rec.snapshot() if e.kind == "sync.degraded"]}

    with tp.resilience_context(deadline_ms=100, retries=0), tp.fault_context(tp.DelayRank(rank=1, delay_ms=300)):
        try:
            tp.gather_all_tensors(torch.arange(3.0))
        except tp.CollectiveTimeoutError as err:
            out["delay"] = {"error": type(err).__name__, "rank": err.rank, "label": err.label, "in_flight": err.in_flight}
    return out
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("resilience_ranks")
    return path, run_two_ranks(path, _TWO_RANKS)


def test_two_ranks_no_policy_issues_the_same_collectives(two_ranks):
    for res in two_ranks[1]:
        assert res["ok"], res
        clean = res["clean"]
        assert clean["sync_collectives"] == clean["buffers"] + (0 if clean["rank_invariant"] else 1), clean
        assert (clean["retries"], clean["degraded"]) == (0, 0)


def test_two_ranks_rank_drop_folds_rank0_states(two_ranks):
    path, results = two_ranks
    for res in results:
        assert res["ok"], res
        assert res["drop"] == {"degraded": 1, "retries": 0, "survivors": [[0]]}, res["drop"]
    local0 = torch.load(path / "local0.pt")
    make = {
        "acc": lambda: tc.MulticlassAccuracy(num_classes=4, device="cpu"),
        "auroc": lambda: tc.MulticlassAUROC(num_classes=4, thresholds=9, device="cpu"),
        "auroc_exact": lambda: tc.MulticlassAUROC(num_classes=4, device="cpu"),
        "cm": lambda: tc.MulticlassConfusionMatrix(num_classes=4, device="cpu"),
    }
    for rank in range(2):
        got = torch.load(path / f"degraded{rank}.pt")
        for name, build in make.items():
            alone = build()
            alone.load_state_dict(local0, prefix=f"{name}.")
            want = alone.compute()
            if want.dtype.is_floating_point:
                torch.testing.assert_close(got[name], want, rtol=0, atol=0)
            else:
                assert torch.equal(got[name], want), (rank, name)


def test_two_ranks_delay_past_deadline_names_the_rank(two_ranks):
    for res in two_ranks[1]:
        assert res["ok"], res
        assert res["delay"] == {"error": "CollectiveTimeoutError", "rank": 1, "label": "eager:shape", "in_flight": False}
