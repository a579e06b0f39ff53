"""The port's transactional layer (``torchmetrics_tpu_torch/engine/txn.py``: quarantine,
the ``error`` admission, the fallback ladder) against the JAX package's
(``torchmetrics_tpu/engine/txn.py``), on the CPU.

The same seeded numpy batches go through both: the JAX package under
``engine_context(True)`` (or with its engine off) and ``quarantine_context``, the port
with its engine forced on (or off) on ``device="cpu"``. Integer states must be equal,
float states within relative 1e-6, and each outcome (the counter, what raised, what
stepped down the ladder) must be the JAX package's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from tests.torch_parity import assert_same_states, config2_members, tier_batches, to_jax, to_port
from torchmetrics_tpu.diag import costs as jax_costs
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.engine import txn as jax_txn
from torchmetrics_tpu.engine.numerics import compensated_context as jax_compensated_context
from torchmetrics_tpu_torch.engine import compiled, config, engine_context, txn
from torchmetrics_tpu_torch.engine.numerics import compensated_context
from torchmetrics_tpu_torch.engine.txn import QuarantinedBatchError, quarantine_context

C = 5


def _acc(side: str, **kw):
    if side == "port":
        return tm.MulticlassAccuracy(C, average="macro", validate_args=False, device="cpu", **kw)
    return jtm.classification.MulticlassAccuracy(C, average="macro", validate_args=False, **kw)


def _stats(side: str, **kw):
    if side == "port":
        return tm.MulticlassStatScores(C, validate_args=False, device="cpu", **kw)
    return jtm.classification.MulticlassStatScores(C, validate_args=False, **kw)


def _jax_engine(on: bool):
    return jax_engine_context(True, donate=True) if on else jax_engine_context(False)


def _poisoned(kind: str, seed: int = 0):
    batches = tier_batches([32, 32, 20, 32, 32], seed=seed)
    bad = [tuple(x.copy() for x in b) for b in batches]
    if kind == "nan":
        bad[2][0][5, 2] = np.nan
    elif kind == "inf":
        bad[2][0][0, 0] = np.inf
    else:
        bad[2][1][7] = C
    clean = [b for i, b in enumerate(batches) if i != 2]
    return bad, clean


# ---------------------------------------------------------------- the mode


@pytest.mark.parametrize("raw", ["", "0", "off", "1", "on", "quarantine", "error", " ERROR ", "banana", "2"])
def test_env_mode_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("TORCHMETRICS_TPU_QUARANTINE", raw)
    try:
        want = jax_txn.quarantine_mode()
    except Exception as err:  # noqa: BLE001
        with pytest.raises(tm.utilities.exceptions.TorchMetricsUserError) as port_err:
            txn.quarantine_mode()
        assert str(port_err.value) == str(err)
        return
    assert txn.quarantine_mode() == want


@pytest.mark.parametrize("value", [True, False, "1", "0", "error", "Error ", 1, None])
def test_set_mode_coerces_as_jax(value):
    try:
        jax_txn.set_quarantine_mode(value)
        want = jax_txn.quarantine_mode()
        txn.set_quarantine_mode(value)
        assert txn.quarantine_mode() == want
    finally:
        jax_txn.set_quarantine_mode(None)
        txn.set_quarantine_mode(None)


def test_set_mode_rejects_as_jax():
    with pytest.raises(ValueError) as jax_err:
        jax_txn.set_quarantine_mode("maybe")
    with pytest.raises(ValueError) as port_err:
        txn.set_quarantine_mode("maybe")
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------- quarantine


@pytest.mark.parametrize("engine", [True, False], ids=["engine", "eager"])
@pytest.mark.parametrize("poison", ["nan", "inf", "label"])
@pytest.mark.parametrize("make", [_acc, _stats], ids=["accuracy", "stat_scores"])
def test_poisoned_batch_is_skipped(engine, poison, make):
    """The state equals the run without the poisoned batch, bit for bit; the counter
    reads 1 and reaches ``quarantined_batches`` at ``compute``; as in the JAX package."""
    bad, clean = _poisoned(poison, seed=hash(poison) % 97)
    with _jax_engine(engine), jax_txn.quarantine_context(True):
        ref = make("jax")
        for b in bad:
            ref.update(*to_jax(b))
        ref_value = ref.compute()
    with engine_context(engine), quarantine_context(True):
        port = make("port")
        for b in bad:
            port.update(*to_port(b))
        value = port.compute()
        stats = txn._stats_for(port)
    assert int(port._quarantined_count) == int(ref._quarantined_count) == 1
    assert stats.quarantined_batches == 1
    assert port.update_count == ref.update_count == len(bad)
    assert_same_states(port, ref)
    without = make("port")
    for b in clean:
        without.update(*to_port(b))
    assert_same_states(port, without)
    np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value), atol=1e-6)
    if engine:
        assert port._engine.stats.eager_fallbacks == 0


def test_ignore_index_minus_one_reads_as_poisoned():
    """Copied as it stands: a multiclass batch with ``ignore_index=-1`` labels fails the
    ``[0, num_classes)`` admission in both packages."""
    batches = tier_batches([32, 32], seed=4)
    batches[1][1][:3] = -1
    with jax_engine_context(True, donate=True), jax_txn.quarantine_context(True):
        ref = _acc("jax", ignore_index=-1)
        for b in batches:
            ref.update(*to_jax(b))
        ref.compute()
    with engine_context(True), quarantine_context(True):
        port = _acc("port", ignore_index=-1)
        for b in batches:
            port.update(*to_port(b))
        port.compute()
    assert int(port._quarantined_count) == int(ref._quarantined_count) == 1
    assert_same_states(port, ref)


@pytest.mark.parametrize("engine", [True, False], ids=["engine", "eager"])
def test_error_mode_raises_before_any_mutation(engine):
    bad, _ = _poisoned("nan", seed=5)
    with _jax_engine(engine), jax_txn.quarantine_context("error"):
        ref = _acc("jax")
        for b in bad[:2]:
            ref.update(*to_jax(b))
        with pytest.raises(jax_txn.QuarantinedBatchError):
            ref.update(*to_jax(bad[2]))
    with engine_context(engine), quarantine_context("error"):
        port = _acc("port")
        for b in bad[:2]:
            port.update(*to_port(b))
        before = {k: getattr(port, k).clone() for k in port._defaults}
        with pytest.raises(QuarantinedBatchError):
            port.update(*to_port(bad[2]))
    assert port.update_count == ref.update_count == 2
    for k, v in before.items():
        assert torch.equal(getattr(port, k), v)
    assert_same_states(port, ref)


def test_error_mode_in_a_fused_collection():
    bad, _ = _poisoned("label", seed=6)
    with engine_context(True), quarantine_context("error"):
        port = tm.MetricCollection(config2_members(True))
        port.update(*to_port(bad[0]))
        counts = {n: m.update_count for n, m in port.items(keep_base=True, copy_state=False)}
        with pytest.raises(QuarantinedBatchError):
            port.update(*to_port(bad[2]))
        assert {n: m.update_count for n, m in port.items(keep_base=True, copy_state=False)} == counts
    with jax_engine_context(True, donate=True), jax_txn.quarantine_context("error"):
        ref = jtm.MetricCollection(config2_members(False))
        ref.update(*to_jax(bad[0]))
        with pytest.raises(jax_txn.QuarantinedBatchError):
            ref.update(*to_jax(bad[2]))
    for name in ("acc", "confmat", "auroc"):
        assert_same_states(port[name], ref[name])


def test_quarantine_in_a_fused_collection():
    bad, clean = _poisoned("nan", seed=7)
    with engine_context(True), quarantine_context(True):
        port = tm.MetricCollection(config2_members(True))
        for b in bad:
            port.update(*to_port(b))
        port.compute()
        assert port._fused_engine.stats.eager_fallbacks == 0
    with jax_engine_context(True, donate=True), jax_txn.quarantine_context(True):
        ref = jtm.MetricCollection(config2_members(False))
        for b in bad:
            ref.update(*to_jax(b))
        ref.compute()
    without = tm.MetricCollection(config2_members(True))
    for b in clean:
        without.update(*to_port(b))
    for name in ("acc", "confmat", "auroc"):
        assert int(port[name]._quarantined_count) == int(ref[name]._quarantined_count) == 1
        assert_same_states(port[name], ref[name])
        assert_same_states(port[name], without[name])


def test_residual_rolls_back_with_its_value():
    """Quarantine and compensation together: a poisoned batch leaves (value, residual)
    bit-exact, on the engine and eagerly, and the JAX package's pair agrees."""
    rng = np.random.RandomState(8)
    xs = [rng.rand(16).astype(np.float32) * 1e-3 for _ in range(6)]
    xs.insert(0, np.full(4, 1e3, np.float32))
    bad = [x.copy() for x in xs]
    bad[3][2] = np.nan
    runs = {}
    for engine in (True, False):
        for name, stream in (("bad", bad), ("clean", xs[:3] + xs[4:])):
            with engine_context(engine), quarantine_context(True), compensated_context(True):
                m = tm.SumMetric(nan_strategy=0.0, device="cpu")
                for x in stream:
                    m.update(torch.from_numpy(x))
                runs[(engine, name)] = (m.value.clone(), m._comp_residuals["value"].clone())
    for engine in (True, False):
        assert torch.equal(runs[(engine, "bad")][0], runs[(engine, "clean")][0])
        assert torch.equal(runs[(engine, "bad")][1], runs[(engine, "clean")][1])
    with jax_engine_context(True, donate=True), jax_txn.quarantine_context(True), jax_compensated_context(True):
        ref = jtm.SumMetric(nan_strategy=0.0)
        for x in bad:
            ref.update(x)
    np.testing.assert_allclose(runs[(True, "bad")][0].numpy(), np.asarray(ref.value), rtol=1e-6)
    np.testing.assert_allclose(runs[(True, "bad")][1].numpy(), np.asarray(ref._comp_residuals["value"]), rtol=1e-6, atol=1e-9)


def test_every_batch_quarantined_warns_at_compute():
    bad, _ = _poisoned("nan", seed=9)
    with engine_context(True), quarantine_context(True):
        port = _acc("port")
        port.update(*to_port(bad[2]))
        with pytest.warns(UserWarning, match="failed quarantine admission"):
            port.compute()


def test_report_and_reset():
    bad, _ = _poisoned("label", seed=10)
    with engine_context(True), quarantine_context(True):
        port = _acc("port")
        for b in bad:
            port.update(*to_port(b))
        rows = {r["owner"]: r for r in txn.quarantine_report()}
        assert rows["MulticlassAccuracy"]["count"] >= 1
        port.reset()
        assert int(port._quarantined_count) == 0
        txn.reset_quarantine()


# ---------------------------------------------------------------- the fallback ladder


def _port_oom_at(monkeypatch, bad_buckets):
    """Allocating a signature's static inputs raises ``torch.OutOfMemoryError`` for a
    bucket in ``bad_buckets`` (the port's counterpart of an XLA compile that runs out of
    device memory)."""
    real = compiled.StaticInputs.__init__

    def flaky(self, inputs, bucket):
        if bucket in bad_buckets:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        real(self, inputs, bucket)

    monkeypatch.setattr(compiled.StaticInputs, "__init__", flaky)


class _FakeXlaRuntimeError(RuntimeError):
    pass


_FakeXlaRuntimeError.__name__ = "XlaRuntimeError"


def _jax_oom_at(monkeypatch, bad_buckets):
    real = jax_costs.aot_compile

    def flaky(fn, owner="", kind="", args=(), donated_bytes=0, **kw):
        for a in args:
            if getattr(a, "ndim", 0) >= 1 and getattr(a, "shape", (0,))[0] in bad_buckets:
                raise _FakeXlaRuntimeError("RESOURCE_EXHAUSTED: out of memory while allocating")
        return real(fn, owner=owner, kind=kind, args=args, donated_bytes=donated_bytes, **kw)

    monkeypatch.setattr(jax_costs, "aot_compile", flaky)


@pytest.mark.parametrize(
    ("bad", "retries"),
    [({64}, 1), ({64, 32}, 3), ({8, 16, 32, 64}, 0)],
    ids=["one-rung", "two-rungs", "exhausted"],
)
@pytest.mark.parametrize("quarantine", [False, True], ids=["plain", "quarantine"])
def test_ladder_steps_down_as_jax(monkeypatch, bad, retries, quarantine):
    """A 50-row batch (bucket 64) whose build runs out of memory retries as half-bucket
    chunks, then eagerly: the value equals eager, ``ladder_retries`` and the fallback
    reasons are the JAX package's. Two failing buckets: 64 -> 32 (fails) -> 16 for the
    head chunk, then the 18-row rest again 32 -> 16: three applied step-downs."""
    (p, t), = tier_batches([50], seed=len(bad))
    if quarantine:
        p[4, 1] = np.nan
    mode = (lambda: quarantine_context(True)) if quarantine else (lambda: quarantine_context(False))
    jmode = (lambda: jax_txn.quarantine_context(True)) if quarantine else (lambda: jax_txn.quarantine_context(False))
    with monkeypatch.context() as mp:
        _jax_oom_at(mp, bad)
        # 32-bit mode: under x64 the JAX state promotes to int64 at its first step and
        # the retried chunks key other signatures, a walk the port (whose states keep
        # their dtype) has no counterpart of
        with jax.enable_x64(False), jax_engine_context(True, donate=True), jmode():
            ref = _acc("jax", compiled_update=True)
            ref.update(*to_jax((p, t)))
            ref_st = ref._engine.stats
            ref_value = ref.compute()
    with monkeypatch.context() as mp:
        _port_oom_at(mp, bad)
        with engine_context(True), mode():
            port = _acc("port", compiled_update=True)
            port.update(*to_port((p, t)))
            st = port._engine.stats
            value = port.compute()
    assert st.ladder_retries == ref_st.ladder_retries == (0 if quarantine else retries)
    assert ("dispatch-resource-exhausted" in st.fallback_reasons) == ("dispatch-resource-exhausted" in ref_st.fallback_reasons)
    assert_same_states(port, ref)
    eager = _acc("port")
    with quarantine_context(quarantine):
        eager.update(*to_port((p, t)))
    assert_same_states(port, eager)
    np.testing.assert_allclose(np.asarray(value), np.asarray(ref_value), atol=1e-6)
    if quarantine:
        assert int(port._quarantined_count) == int(ref._quarantined_count) == 1


def test_persistent_failure_demotes_after_the_budget(monkeypatch):
    monkeypatch.setattr(config, "BUCKETING_ENABLED", False)
    attempts = {"n": 0}
    real = compiled.StaticInputs.__init__

    def always(self, inputs, bucket):
        attempts["n"] += 1
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(compiled.StaticInputs, "__init__", always)
    batches = tier_batches([50] * (txn.TRANSIENT_RETRY_BUDGET + 3), seed=13)
    with engine_context(True):
        m = _acc("port", compiled_update=True)
        for b in batches:
            m.update(*to_port(b))
    st = m._engine.stats
    assert attempts["n"] == txn.TRANSIENT_RETRY_BUDGET
    assert st.fallback_reasons["dispatch-resource-exhausted-budget"] == 1
    assert st.fallback_reasons["uncompilable-signature"] == len(batches) - txn.TRANSIENT_RETRY_BUDGET
    monkeypatch.setattr(compiled.StaticInputs, "__init__", real)
    assert_same_states(m, _acc_eager(batches))
    assert jax_txn.TRANSIENT_RETRY_BUDGET == txn.TRANSIENT_RETRY_BUDGET


def _acc_eager(batches):
    m = _acc("port")
    for b in batches:
        m.update(*to_port(b))
    return m


def test_structural_failure_still_demotes_at_once():
    class Hosty(tm.Metric):
        full_state_update = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("seen", torch.zeros(()), dist_reduce_fx="sum")

        def update(self, x):
            self.seen = self.seen + len(torch.unique(x))

        def compute(self):
            return self.seen

    with engine_context(True):
        m = Hosty(device="cpu", compiled_update=True)
        m.update(torch.arange(8.0))
        m.update(torch.arange(8.0))
    assert m._engine.stats.ladder_retries == 0 and m._engine.stats.eager_fallbacks == 2
    assert float(m.compute()) == 16.0


@pytest.mark.parametrize(
    ("exc", "want"),
    [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20 MiB"), "resource-exhausted"),
        (MemoryError(), "resource-exhausted"),
        (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), "resource-exhausted"),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "xla-runtime"),
        (RuntimeError("CUDA error: operation not permitted when stream is capturing"), None),
        (RuntimeError("CUDA error: operation failed due to a previous error during capture"), None),
        (RuntimeError("cudaErrorStreamCaptureInvalidated: capture invalidated"), None),
        (RuntimeError("CUDA error: operation would make the legacy stream depend on a capturing blocking stream"), None),
        (ValueError("shapes do not match"), None),
        (TypeError("no"), None),
    ],
)
def test_classify_dispatch_error(exc, want):
    assert txn.classify_dispatch_error(exc) == want
    if not isinstance(exc, (torch.OutOfMemoryError, RuntimeError)) or "RESOURCE" in str(exc):
        assert jax_txn.classify_dispatch_error(exc) == want
