"""Checkpoints of metric state (``utilities/checkpoint.py``) and the state carry of
``interop.py``, against the JAX package, on the CPU.

A resume saves after some batches, restores into fresh metrics, and runs the rest;
the states must equal those of the uninterrupted run exactly. Round trips: port to
port, a JAX-written ``.npz`` into the port, and a port-written one into the JAX
package (run on its ``.npz`` route: ``_ORBAX_AVAILABLE`` is patched off in the test).
Covered: tensor and list states, a collection with compute groups, the persistence
flags put back after a save, cached values dropped by a restore, and float64 states.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.utilities.checkpoint as jckpt
import torchmetrics_tpu_torch as tm
from tests.torch_parity import np_
from torchmetrics_tpu_torch.interop import state_from_jax
from torchmetrics_tpu_torch.utilities.checkpoint import restore_metric_state, save_metric_state

C, N = 5, 40
_RNG = np.random.default_rng(21)
MC = [(_RNG.uniform(0, 1, (N, C)).astype(np.float32), _RNG.integers(0, C, N)) for _ in range(4)]
LOSS = [(_RNG.standard_normal(n).astype(np.float32),) for n in (7, 3, 12, 5)]


def _port_accuracy():
    return tm.MulticlassAccuracy(num_classes=C, device="cpu")


def _port_collection():
    return tm.MetricCollection({
        "acc": tm.MulticlassAccuracy(num_classes=C, device="cpu"),
        "f1": tm.MulticlassF1Score(num_classes=C, device="cpu"),
        "cm": tm.MulticlassConfusionMatrix(num_classes=C, device="cpu"),
        "auroc": tm.MulticlassAUROC(num_classes=C, device="cpu"),
    })


def _jax_collection():
    return jtm.MetricCollection({
        "acc": jc.MulticlassAccuracy(num_classes=C),
        "f1": jc.MulticlassF1Score(num_classes=C),
        "cm": jc.MulticlassConfusionMatrix(num_classes=C),
        "auroc": jc.MulticlassAUROC(num_classes=C),
    })


CASES = {
    "accuracy": (_port_accuracy, lambda: jc.MulticlassAccuracy(num_classes=C), MC),
    "mean": (lambda: tm.MeanMetric(device="cpu"), lambda: jtm.MeanMetric(), LOSS),
    "cat (list state)": (lambda: tm.CatMetric(device="cpu"), lambda: jtm.CatMetric(), LOSS),
    "exact auroc (list states)": (lambda: tm.MulticlassAUROC(num_classes=C, device="cpu"),
                                  lambda: jc.MulticlassAUROC(num_classes=C), MC),
    "collection (compute groups)": (_port_collection, _jax_collection, MC),
}


def _port_batch(b):
    return tuple(torch.from_numpy(x) for x in b)


def _jax_batch(b):
    return tuple(jnp.asarray(x) for x in b)


def _states(metric):
    """Every state by ``state_dict`` key, as numpy (lists concatenated), with the counts."""
    flags = [dict(m._persistent) for m in _leaves(metric)]
    metric.persistent(True)
    out = {}
    for key, value in metric.state_dict().items():
        if isinstance(value, list):
            out[key] = np.concatenate([np_(v).reshape(-1) for v in value]) if value else np.zeros(0)
        else:
            out[key] = np_(value) if not isinstance(value, int) else np.asarray(value)
    for m, saved in zip(_leaves(metric), flags):
        m._persistent.update(saved)
    return out


def _leaves(metric):
    if isinstance(metric, (tm.MetricCollection, jtm.MetricCollection)):
        return list(metric.values(copy_state=False))
    return [metric]


def _assert_same_states(got, want):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.fixture
def jax_npz_route(monkeypatch):
    monkeypatch.setattr(jckpt, "_ORBAX_AVAILABLE", False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_resume_equals_the_uninterrupted_run(case, tmp_path):
    make_port, _, batches = CASES[case]
    whole = make_port()
    for b in batches:
        whole.update(*_port_batch(b))
    first = make_port()
    for b in batches[:2]:
        first.update(*_port_batch(b))
    flags = [dict(m._persistent) for m in _leaves(first)]
    save_metric_state(first, str(tmp_path / "ckpt"))
    assert [dict(m._persistent) for m in _leaves(first)] == flags  # put back after the save
    resumed = restore_metric_state(make_port(), str(tmp_path / "ckpt.npz"))
    _assert_same_states(_states(resumed), _states(first))
    for b in batches[2:]:
        resumed.update(*_port_batch(b))
    _assert_same_states(_states(resumed), _states(whole))
    np.testing.assert_array_equal(np_(_value(resumed)), np_(_value(whole)))


def _value(metric):
    value = metric.compute()
    return np.concatenate([np_(v).reshape(-1) for v in value.values()]) if isinstance(value, dict) else value


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_npz_restores_into_the_port(case, tmp_path, jax_npz_route):
    make_port, make_ref, batches = CASES[case]
    ref = make_ref()
    for b in batches[:2]:
        ref.update(*_jax_batch(b))
    jckpt.save_metric_state(ref, str(tmp_path / "jax"))
    port = restore_metric_state(make_port(), str(tmp_path / "jax.npz"))
    for b in batches[2:]:
        ref.update(*_jax_batch(b))
        port.update(*_port_batch(b))
    got, want = _states(port), _states(ref)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
        assert got[key].dtype.kind == want[key].dtype.kind, key


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_npz_restores_into_jax(case, tmp_path, jax_npz_route):
    make_port, make_ref, batches = CASES[case]
    port = make_port()
    for b in batches[:2]:
        port.update(*_port_batch(b))
    save_metric_state(port, str(tmp_path / "port.npz"))
    ref = jckpt.restore_metric_state(make_ref(), str(tmp_path / "port.npz"))
    _assert_same_states(_states(ref), _states(port))
    for b in batches[2:]:
        ref.update(*_jax_batch(b))
        port.update(*_port_batch(b))
    got, want = _states(port), _states(ref)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_restore_drops_the_cached_value(tmp_path):
    metric = tm.SumMetric(device="cpu")
    metric.update(torch.tensor([1.0, 2.0]))
    save_metric_state(metric, str(tmp_path / "s"))
    metric.update(torch.tensor([10.0]))
    assert float(metric.compute()) == 13.0
    restore_metric_state(metric, str(tmp_path / "s"))
    assert float(metric.compute()) == 3.0 and metric.update_count == 1


def test_save_writes_every_state_whatever_its_flag(tmp_path):
    metric = tm.MeanMetric(device="cpu")
    metric.update(torch.tensor([1.0, 2.0]))
    assert metric.state_dict() == {}  # no state is persistent by default
    save_metric_state(metric, str(tmp_path / "m"))
    with np.load(tmp_path / "m.npz") as npz:
        assert sorted(npz.files) == ["_update_count", "value", "weight"]
    assert not any(metric._persistent.values())


def test_restore_refuses_counts_past_int32(tmp_path):
    np.savez(tmp_path / "big.npz", tp=np.full(C, 2**31, dtype=np.int64), _update_count=np.asarray(1))
    with pytest.raises(ValueError, match="int32"):
        restore_metric_state(tm.MulticlassAccuracy(num_classes=C, device="cpu"), str(tmp_path / "big.npz"))


# ------------------------------------------------------------------ interop.py


def test_carried_float64_state_keeps_float64():
    """A JAX float64 sum carried onto a port metric cast with ``set_dtype(float64)``
    keeps its dtype and every bit (1 + 1e-8 is not a float32 value)."""
    ref = jtm.SumMetric().set_dtype(jnp.float64)
    ref.persistent(True)
    ref.update(jnp.asarray([1.0]))
    ref.update(jnp.asarray([1e-8]))  # each batch sums in float32, the state in float64
    port = tm.SumMetric(device="cpu").set_dtype(torch.float64)
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.value.dtype == torch.float64
    assert port.value.item() == float(np.asarray(ref.value)) != float(np.float32(np.asarray(ref.value)))
    port.update(torch.tensor([1.0]))
    ref.update(jnp.asarray([1.0]))
    assert port.value.item() == float(np.asarray(ref.value))


def test_carried_float_state_takes_the_port_metric_dtype():
    ref = jtm.SumMetric().set_dtype(jnp.float64)
    ref.persistent(True)
    ref.update(jnp.asarray([0.5]))
    port = tm.SumMetric(device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.value.dtype == torch.float32 and port.value.item() == 0.5


def test_carry_cat_metric_list_state():
    ref = jtm.CatMetric()
    ref.persistent(True)
    port = tm.CatMetric(device="cpu")
    for (b,) in LOSS[:2]:
        ref.update(jnp.asarray(b))
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.update_count == 2 and len(port.value) == 2
    for (b,) in LOSS[2:]:
        ref.update(jnp.asarray(b))
        port.update(torch.from_numpy(b))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))
