"""The port's K-step scan queue (``torchmetrics_tpu_torch/engine/scan.py``) against the
JAX package's (``torchmetrics_tpu/engine/scan.py``), on the CPU.

The same seeded numpy batches go through the JAX package under
``engine_context(True)`` and ``scan_context(K)`` and through the port with its engine
forced on (``device="cpu"``, where a drain runs the same masked step body ``kb`` times
on the static buffers a K-step graph would use). Integer states must be equal, float
states within relative 1e-6, values within 1e-6; the scan counters
(``scan_dispatches``, ``scan_steps_folded``, ``scan_pad_steps``, ``scan_flushes`` and
their reasons) must match wherever the mechanisms correspond.
"""

from __future__ import annotations

import copy
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from tests.torch_parity import assert_same_states, config2_members, tier_batches, to_jax, to_port
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.engine.numerics import compensated_context as jax_compensated_context
from torchmetrics_tpu.engine.scan import coerce_k as jax_coerce_k
from torchmetrics_tpu.engine.scan import k_bucket as jax_k_bucket
from torchmetrics_tpu.engine.scan import scan_context as jax_scan_context
from torchmetrics_tpu.engine.scan import scan_k as jax_scan_k
from torchmetrics_tpu.engine.txn import quarantine_context as jax_quarantine_context
from torchmetrics_tpu_torch.engine import engine_context, scan_context
from torchmetrics_tpu_torch.engine.numerics import compensated_context
from torchmetrics_tpu_torch.engine.scan import MAX_K, coerce_k, k_bucket, scan_k
from torchmetrics_tpu_torch.engine.txn import quarantine_context
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

C = 5
VALUE_ATOL = 1e-6
_SCAN_COUNTERS = ("scan_dispatches", "scan_steps_folded", "scan_pad_steps", "scan_flushes")
# a stream with ragged sizes: buckets 32, 32, 32, 32, 8, 32, 16, 32
SIZES = (32, 32, 32, 20, 7, 32, 9, 30)


def _metric(side: str, kind: str, **kw):
    pkg = tm if side == "port" else jtm.classification
    dev = {"device": "cpu"} if side == "port" else {}
    if kind == "accuracy":
        return pkg.MulticlassAccuracy(C, average="macro", validate_args=False, **dev, **kw)
    if kind == "stat_scores":
        return pkg.MulticlassStatScores(C, validate_args=False, **dev, **kw)
    return pkg.MulticlassConfusionMatrix(C, validate_args=False, **dev, **kw)


def _scan_counters(stats) -> dict:
    out = {f: getattr(stats, f) for f in _SCAN_COUNTERS}
    out["scan_flush_reasons"] = dict(stats.scan_flush_reasons)
    return out


def _run_jax(kind: str, batches, k: int, observe=None):
    with jax_engine_context(True, donate=True), jax_scan_context(k):
        m = _metric("jax", kind)
        for b in batches:
            m.update(*to_jax(b))
        value = m.compute()
    return m, value


def _run_port(kind: str, batches, k: int):
    with engine_context(True), scan_context(k):
        m = _metric("port", kind)
        for b in batches:
            m.update(*to_port(b))
        value = m.compute()
    return m, value


def _run_eager(kind: str, batches):
    m = _metric("port", kind)
    for b in batches:
        m.update(*to_port(b))
    return m


# ---------------------------------------------------------------- knobs


@pytest.mark.parametrize("value", [None, 0, False, 2, 3, 8, MAX_K])
def test_coerce_k_accepts_the_jax_values(value):
    assert coerce_k(value) == jax_coerce_k(value)


@pytest.mark.parametrize("value", [True, 1, -1, MAX_K + 1, 2.5, "8"])
def test_coerce_k_raises_as_jax_does(value):
    with pytest.raises(Exception) as jax_err:
        jax_coerce_k(value)
    with pytest.raises(TorchMetricsUserError) as port_err:
        coerce_k(value)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("raw", ["", "0", "off", "2", "16", "banana", "1", "-3", str(MAX_K + 1), "2.5"])
def test_env_var_resolves_as_jax(monkeypatch, raw):
    monkeypatch.setenv("TORCHMETRICS_TPU_SCAN", raw)
    try:
        want = jax_scan_k()
    except Exception as err:  # noqa: BLE001 -- the port must raise the same text
        with pytest.raises(TorchMetricsUserError, match="TORCHMETRICS_TPU_SCAN"):
            scan_k()
        assert type(err).__name__ == "TorchMetricsUserError"
        return
    assert scan_k() == want


def test_kwarg_outranks_the_context():
    with engine_context(True), scan_context(4):
        off = _metric("port", "accuracy", scan_steps=0)
        deep = _metric("port", "accuracy", scan_steps=8)
        assert off._scan_depth() is None and deep._scan_depth() == 8
        assert _metric("port", "accuracy")._scan_depth() == 4
    assert _metric("port", "accuracy")._scan_depth() is None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 9, 1000])
def test_k_bucket_matches_jax(n):
    assert k_bucket(n) == jax_k_bucket(n)


# ---------------------------------------------------------------- parity


@pytest.mark.parametrize("kind", ["accuracy", "stat_scores", "confmat"])
@pytest.mark.parametrize("k", [2, 8])
def test_scan_matches_jax_and_eager(kind, k):
    """States, value and the scan counters against the JAX scan; states bit-equal to the
    port's eager run."""
    batches = tier_batches(SIZES, seed=k)
    ref, ref_value = _run_jax(kind, batches, k)
    port, value = _run_port(kind, batches, k)
    assert_same_states(port, ref)
    assert_same_states(port, _run_eager(kind, batches))
    np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value), atol=VALUE_ATOL)
    assert _scan_counters(port._engine.stats) == _scan_counters(ref._engine.stats)
    assert port._engine.stats.eager_fallbacks == 0


@pytest.mark.parametrize("steps", [1, 3, 5, 7])
def test_ragged_tails_reuse_the_kb_graphs(steps):
    """S queued steps drain through ``k_bucket(S)``; the kb graphs of a signature stay
    within log2(K) + 1, and pad steps never move a state."""
    k = 8
    batches = tier_batches([32] * steps, seed=steps)
    ref, _ = _run_jax("accuracy", batches, k)
    port, _ = _run_port("accuracy", batches, k)
    st = port._engine.stats
    assert st.scan_steps_folded == steps and st.scan_pad_steps == k_bucket(steps) - steps
    assert_same_states(port, ref)
    assert_same_states(port, _run_eager("accuracy", batches))
    # every tail length in one stream: 1..8 queued steps, one signature
    with engine_context(True), scan_context(k):
        m = _metric("port", "accuracy")
        eager = _metric("port", "accuracy")
        for tail in range(1, k + 1):
            for b in tier_batches([32] * tail, seed=tail):
                m.update(*to_port(b))
                eager.update(*to_port(b))
            m.compute()
    (plan,) = [p for p in m._engine._scan._plans.values()]
    (ring,) = plan.rings
    assert sorted(ring.built) == [1, 2, 4, 8]
    assert len(ring.built) <= int(math.log2(k)) + 1
    assert_same_states(m, eager)


# ---------------------------------------------------------------- flush points


def _queued(n: int = 3, k: int = 8, kind: str = "accuracy", seed: int = 0):
    batches = tier_batches([32] * n, seed=seed)
    m = _metric("port", kind, scan_steps=k)
    for b in batches:
        m.update(*to_port(b))
    assert m._engine._scan.pending == n
    return m, batches


def _observe(name: str, m, batches, tmp_dir=None):
    if name == "compute":
        return m.compute()
    if name == "forward":
        return m(*to_port(tier_batches([32], seed=99)[0]))
    if name == "merge_state":
        other = _metric("port", "accuracy")
        other.update(*to_port(tier_batches([32], seed=98)[0]))
        return m.merge_state(other)
    if name == "sync":
        m.sync(distributed_available=lambda: True)
        m.unsync()
        return None
    if name == "state_dict":
        m.persistent(True)
        return m.state_dict()
    if name == "clone":
        return m.clone()
    if name == "pickle":
        return pickle.loads(pickle.dumps(m))
    if name == "deepcopy":
        return copy.deepcopy(m)
    if name == "to":
        return m.to("cpu")
    if name == "set_dtype":
        return m.set_dtype(torch.float32)
    if name == "state_footprint":
        return m.state_footprint()
    if name == "checkpoint":
        from torchmetrics_tpu_torch.utilities.checkpoint import save_metric_state

        return save_metric_state(m, str(tmp_dir / "queued.npz"))
    if name == "load_state_dict":
        # the state the queued steps lead to, from an eager twin: the load replaces it
        twin = _run_eager("accuracy", batches)
        twin.persistent(True)
        return m.load_state_dict(twin.state_dict())
    raise AssertionError(name)


@pytest.mark.parametrize(
    "observation",
    ["compute", "forward", "merge_state", "sync", "state_dict", "clone", "pickle", "deepcopy", "to", "set_dtype",
     "state_footprint", "load_state_dict", "checkpoint"],
)
def test_every_observation_drains_first(observation, tmp_path):
    with engine_context(True):
        m, batches = _queued()
        out = _observe(observation, m, batches, tmp_path)
        assert m._engine._scan.pending == 0
        st = m._engine.stats
        assert st.scan_dispatches == 1 and st.scan_steps_folded == 3
        reason = {"pickle": "clone", "deepcopy": "clone", "to": "device-move", "checkpoint": "state_dict"}.get(
            observation, observation
        )
        assert st.scan_flush_reasons[f"observation:{reason}"] == 1
    eager = _run_eager("accuracy", batches)
    if observation not in ("forward", "merge_state"):
        assert_same_states(m, eager)
    if observation in ("clone", "pickle", "deepcopy"):
        assert_same_states(out, eager)


def test_reset_discards_without_dispatch():
    with engine_context(True):
        m, _ = _queued()
        m.reset()
        st = m._engine.stats
        assert m._engine._scan.pending == 0 and st.scan_dispatches == 0
        assert st.scan_flush_reasons["reset"] == 1
        assert_same_states(m, _metric("port", "accuracy"))
    with jax_engine_context(True, donate=True):
        ref = _metric("jax", "accuracy", scan_steps=8)
        for b in tier_batches([32] * 3):
            ref.update(*to_jax(b))
        ref.reset()
        assert ref._engine.stats.scan_dispatches == 0 and ref._engine.stats.scan_flush_reasons["reset"] == 1


def test_scope_exit_and_disabled_engine_drain():
    batches = tier_batches([32] * 3, seed=5)
    with engine_context(True):
        with scan_context(8):
            m = _metric("port", "accuracy")
            for b in batches:
                m.update(*to_port(b))
            assert m._engine._scan.pending == 3
        assert m._engine._scan.pending == 0
        assert m._engine.stats.scan_flush_reasons["scope-exit"] == 1
        m2 = _metric("port", "accuracy", scan_steps=8)
        for b in batches:
            m2.update(*to_port(b))
    with engine_context(False):
        m2.update(*to_port(batches[0]))  # the engine is off: the queue drains first
    assert m2._engine.stats.scan_flush_reasons["scan-disabled"] == 1
    assert_same_states(m, _run_eager("accuracy", batches))
    assert_same_states(m2, _run_eager("accuracy", batches + batches[:1]))


def test_signature_change_drains_in_order():
    batches = tier_batches([32, 32, 7, 32], seed=3)
    ref, _ = _run_jax("confmat", batches, 8)
    port, _ = _run_port("confmat", batches, 8)
    assert port._engine.stats.scan_flush_reasons == ref._engine.stats.scan_flush_reasons
    assert_same_states(port, ref)


def test_the_caller_mutating_its_batch_in_place():
    """The enqueue copies the batch into its slot: a caller that reuses its tensors in
    place after ``update()`` does not change what the drain reads."""
    batches = tier_batches([32] * 4, seed=11)
    preds, target = (torch.zeros_like(x) for x in to_port(batches[0]))
    with engine_context(True), scan_context(8):
        m = _metric("port", "accuracy")
        for b in batches:
            p, t = to_port(b)
            preds.copy_(p)
            target.copy_(t)
            m.update(preds, target)
            preds.fill_(float("nan"))
            target.fill_(0)
        value = m.compute()
    eager = _run_eager("accuracy", batches)
    assert_same_states(m, eager)
    assert torch.equal(value, eager.compute())


def test_running_slot_sees_the_drained_state():
    values = [torch.tensor([float(i), 2.0 * i]) for i in range(1, 8)]
    with engine_context(True), scan_context(4):
        port = tm.Running(tm.SumMetric(nan_strategy=0.0, device="cpu"), window=3)
        for v in values:
            port.update(v)
        got = port.compute()
    eager = tm.Running(tm.SumMetric(nan_strategy=0.0, device="cpu"), window=3)
    for v in values:
        eager.update(v)
    assert torch.equal(got, eager.compute())


# ---------------------------------------------------------------- riders in the scan


def test_quarantine_inside_the_scan():
    """A NaN batch and an out-of-range label mid-queue roll back only themselves; the
    state equals the run without them, bit for bit, and the counter reads 2."""
    batches = tier_batches(SIZES, seed=21)
    poisoned = [tuple(x.copy() for x in b) for b in batches]
    poisoned[2][0][3, 1] = np.nan
    poisoned[5][1][0] = C + 2
    clean = [b for i, b in enumerate(batches) if i not in (2, 5)]
    with jax_quarantine_context(True):
        ref, _ = _run_jax("stat_scores", poisoned, 4)
        assert int(ref._quarantined_count) == 2
    with quarantine_context(True):
        port, _ = _run_port("stat_scores", poisoned, 4)
    assert int(port._quarantined_count) == 2 and port._engine.stats.quarantined_batches == 2
    assert_same_states(port, ref)
    assert_same_states(port, _run_eager("stat_scores", clean))


class _FloatSum:
    """A compensated float sum (the MeanSquaredError shape: one additive float state)."""

    @staticmethod
    def make(side: str):
        base = tm.Metric if side == "port" else jtm.Metric
        zeros = torch.zeros(()) if side == "port" else jnp.zeros((), jnp.float32)

        class FloatSum(base):
            full_state_update = False
            _engine_state_additive = True

            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", zeros, dist_reduce_fx="sum")

            def update(self, x):
                self.total = self.total + (x * x).sum()

            def compute(self):
                return self.total

        return FloatSum(**({"device": "cpu"} if side == "port" else {}))


def test_compensation_inside_the_scan_is_bit_equal_to_one_step():
    rng = np.random.RandomState(3)
    xs = [rng.rand(64).astype(np.float32) * 1e-3 for _ in range(37)]
    anchor = np.full(1, 300.0, np.float32)
    with engine_context(True), compensated_context(True):
        scanned = _FloatSum.make("port")
        one_step = _FloatSum.make("port")
        scanned.scan_steps = 8
        for x in [anchor, *xs]:
            scanned.update(torch.from_numpy(x))
            one_step.update(torch.from_numpy(x))
        scanned._drain_scan("test")
        assert torch.equal(scanned.total, one_step.total)
        assert torch.equal(scanned._comp_residuals["total"], one_step._comp_residuals["total"])
    with jax_engine_context(True, donate=True), jax_scan_context(8), jax_compensated_context(True):
        ref = _FloatSum.make("jax")
        for x in [anchor, *xs]:
            ref.update(jnp.asarray(x))
        ref._drain_scan("test")
    np.testing.assert_allclose(scanned.total.numpy(), np.asarray(ref.total), rtol=1e-6)
    np.testing.assert_allclose(
        scanned._comp_residuals["total"].numpy(), np.asarray(ref._comp_residuals["total"]), rtol=1e-6, atol=1e-9
    )


# ---------------------------------------------------------------- the config #2 collection


def _collection(side: str, **kwargs):
    if side == "port":
        return tm.MetricCollection(config2_members(True), **kwargs)
    return jtm.MetricCollection(config2_members(False), **kwargs)


@pytest.mark.parametrize("k", [2, 8])
def test_config2_collection_scans_its_fused_owners(k):
    """The stat-scores and confusion-matrix owners ride the fused queue; the binned
    AUROC falls back and updates eagerly on every step, as in the JAX package."""
    batches = tier_batches(SIZES, seed=30 + k)
    with jax_engine_context(True, donate=True):
        ref = _collection("jax", scan_steps=k)
        for b in batches:
            ref.update(*to_jax(b))
        ref_out = ref.compute()
    with engine_context(True):
        port = _collection("port", scan_steps=k)
        for b in batches:
            port.update(*to_port(b))
        fe = port._fused_engine
        handled = fe._scan._plan.names
        out = port.compute()
    eager = _collection("port")
    for b in batches:
        eager.update(*to_port(b))
    # the groups settle when the collection is built (every member declares a
    # reduction signature), so every step rides the queue; owners by name order
    assert port.compute_groups == {0: ["acc", "acc_w", "stats"], 1: ["auroc"], 2: ["confmat", "confmat_t"]}
    assert handled == {"acc", "confmat"}
    assert port._fused_engine.stats.scan_steps_folded == len(batches)
    for name in ("stats", "acc", "acc_w", "auroc", "confmat", "confmat_t"):
        assert_same_states(port[name], ref[name])
        assert_same_states(port[name], eager[name])
        np.testing.assert_allclose(np.asarray(out[name]), np.asarray(ref_out[name]), atol=1e-6)
    auroc = port["auroc"]
    assert auroc._engine.stats.eager_fallbacks == len(batches)


def test_view_member_observation_drains_the_owner():
    batches = tier_batches([32] * 3, seed=41)
    with engine_context(True):
        port = _collection("port", scan_steps=8)
        for b in batches:
            port.update(*to_port(b))
        view = port._modules["stats"]  # a view of the "acc" owner, read without the accessor
        assert port._fused_engine._scan.pending == len(batches)
        value = view.compute()
        assert port._fused_engine._scan.pending == 0
    eager = _collection("port")
    for b in batches:
        eager.update(*to_port(b))
    assert torch.equal(value, eager["stats"].compute())


@pytest.mark.parametrize(
    ("observation", "reason"),
    [
        (lambda mc: mc.compute(), "compute"),
        (lambda mc: mc.state_dict(), "state_dict"),
        (lambda mc: mc.clone(), "clone"),
        (lambda mc: mc.load_state_dict({}), "load_state_dict"),
        (lambda mc: mc.to("cpu"), "device-move"),
        (lambda mc: mc.set_dtype(torch.float32), "set_dtype"),
        (lambda mc: mc.state_footprint(), "state_footprint"),
        (lambda mc: mc.add_metrics({"extra": tm.MulticlassAccuracy(C, device="cpu")}), "membership-change"),
    ],
    ids=["compute", "state_dict", "clone", "load_state_dict", "to", "set_dtype", "state_footprint", "add_metrics"],
)
def test_collection_observations_drain_the_fused_queue(observation, reason):
    batches = tier_batches([32] * 3, seed=43)
    with engine_context(True):
        port = _collection("port", scan_steps=8)
        for b in batches:
            port.update(*to_port(b))
        fe = port._fused_engine
        assert fe._scan.pending == len(batches)
        observation(port)
        assert fe._scan.pending == 0
        assert fe.stats.scan_flush_reasons[f"observation:{reason}"] == 1
    eager = _collection("port")
    for b in batches:
        eager.update(*to_port(b))
    for name in ("stats", "acc", "confmat", "confmat_t", "auroc"):
        assert_same_states(port[name], eager[name])


def test_collection_reset_discards_and_forward_drains():
    batches = tier_batches([32] * 4, seed=42)
    with engine_context(True):
        port = _collection("port", scan_steps=8)
        for b in batches:
            port.update(*to_port(b))
        port.reset()
        st = port._fused_engine.stats
        assert st.scan_dispatches == 0 and st.scan_flush_reasons["reset"] == 1
        for b in batches:
            port.update(*to_port(b))
        port(*to_port(batches[0]))
        assert st.scan_flush_reasons["observation:forward"] == 1
    eager = _collection("port")
    for b in batches:
        eager.update(*to_port(b))
    eager(*to_port(batches[0]))
    for name in ("stats", "confmat", "auroc"):
        assert_same_states(port[name], eager[name])
