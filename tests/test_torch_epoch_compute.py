"""The port's cached compute and fused sync-and-compute (``torchmetrics_tpu_torch/engine/epoch.py``)
against the eager compute and the JAX package's (``torchmetrics_tpu/engine/epoch.py``),
on the CPU.

With the engine on, ``compute`` runs once per state signature under the update
engine's guard (and, on the card, is captured); later computes copy the states in and
run it again. The value must equal the eager compute's exactly and the JAX package's
within relative 1e-6 (float sums added in other orders); a compute that cannot be
cached falls back with a ``compute:`` reason. Across two gloo ranks, the fused route
(the packed exchange, then one graph for the fold and the compute) must equal the
``merge_state`` fold of the two ranks' states.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as tm
from tests.test_torch_sync_guard import run_two_ranks
from tests.torch_parity import assert_close, tier_batches, to_jax, to_port
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu_torch.engine import engine_context

C = 5

# name -> (port factory, JAX factory, input kind)
CASES = {
    "accuracy": (lambda: tm.MulticlassAccuracy(C, device="cpu"), lambda: jtm.classification.MulticlassAccuracy(C), "multiclass"),
    "accuracy_micro": (
        lambda: tm.MulticlassAccuracy(C, average="micro", device="cpu"),
        lambda: jtm.classification.MulticlassAccuracy(C, average="micro"),
        "multiclass",
    ),
    "stat_scores": (lambda: tm.MulticlassStatScores(C, device="cpu"), lambda: jtm.classification.MulticlassStatScores(C), "multiclass"),
    "confmat": (lambda: tm.MulticlassConfusionMatrix(C, device="cpu"), lambda: jtm.classification.MulticlassConfusionMatrix(C), "multiclass"),
    "f1": (lambda: tm.MulticlassF1Score(C, device="cpu"), lambda: jtm.classification.MulticlassF1Score(C), "multiclass"),
    "jaccard": (lambda: tm.MulticlassJaccardIndex(C, device="cpu"), lambda: jtm.classification.MulticlassJaccardIndex(C), "multiclass"),
    "binary_auroc": (
        lambda: tm.BinaryAUROC(thresholds=10, device="cpu"),
        lambda: jtm.classification.BinaryAUROC(thresholds=10),
        "binary",
    ),
    "sum": (lambda: tm.SumMetric(device="cpu"), lambda: jtm.SumMetric(), "values"),
    "mean": (lambda: tm.MeanMetric(device="cpu"), lambda: jtm.MeanMetric(), "values"),
    "max": (lambda: tm.MaxMetric(device="cpu"), lambda: jtm.MaxMetric(), "values"),
}


def _inputs(kind: str, batch, conv):
    preds, target = batch
    if kind == "binary":
        return conv((preds[:, 0], (target > 2).astype(np.int64)))
    if kind == "values":
        return conv((preds[:, 0],))
    return conv((preds, target))


@pytest.mark.parametrize("name", sorted(CASES))
def test_cached_compute_equals_eager_and_jax(name):
    make_port, make_jax, kind = CASES[name]
    batches = tier_batches([32, 32, 20], seed=len(name))
    with engine_context(True):
        port = make_port()
        values = []
        for b in batches:
            port.update(*_inputs(kind, b, to_port))
            values.append(port.compute())
        st = port._epoch.stats
    assert (st.compute_traces, st.compute_dispatches, st.compute_cache_hits) == (1, len(batches), len(batches) - 1)
    assert st.eager_fallbacks == 0
    eager = make_port()
    with jax_engine_context(True, donate=True):
        ref = make_jax()
        ref_values = []
        for b in batches:
            ref.update(*_inputs(kind, b, to_jax))
            ref_values.append(ref.compute())
    for i, b in enumerate(batches):
        eager.update(*_inputs(kind, b, to_port))
        want = eager.compute()
        assert_close(values[i], want, 0.0, msg=f"{name} compute {i} against eager")
        assert_close(values[i], ref_values[i], 0.0, rtol=1e-6, msg=f"{name} compute {i} against JAX")


def test_value_never_shares_a_buffer():
    """``SumMetric.compute`` returns its state: the cached route hands out a copy, never the
    metric's state nor the graph's static copy of it."""
    with engine_context(True):
        m = tm.SumMetric(device="cpu")
        for x in (1.0, 2.0, 3.0):
            m.update(torch.tensor([x]))
            value = m.compute()
            (call,) = m._epoch._compute_cache.values()
            storages = {m.value.untyped_storage().data_ptr(), call.inputs["value"].untyped_storage().data_ptr()}
            assert value.untyped_storage().data_ptr() not in storages
        held = value.clone()
        m.update(torch.tensor([10.0]))
        m.compute()
        assert torch.equal(value, held)


@pytest.mark.parametrize(
    ("make", "reason"),
    [
        (lambda: tm.MinMaxMetric(tm.SumMetric(device="cpu")), "compute:nested-metric"),
        (lambda: tm.SumMetric(device="cpu", compute_on_cpu=True), "compute:compute-on-cpu"),
        (lambda: tm.CatMetric(device="cpu"), "compute:list-state"),
        (lambda: tm.MulticlassConfusionMatrix(C, normalize="true", device="cpu"), "compute:host-read:_local_scalar_dense"),
        (lambda: tm.MulticlassMatthewsCorrCoef(C, device="cpu"), "compute:host-data:lift_fresh"),
    ],
    ids=["nested", "compute-on-cpu", "list-state", "host-read", "host-data"],
)
def test_fallback_reasons(make, reason):
    batches = tier_batches([16, 16], seed=2)
    with engine_context(True):
        m = make()
        eager = make()
        for b in batches:
            args = (torch.from_numpy(b[0][:, 0]),) if isinstance(m, (tm.SumMetric, tm.CatMetric, tm.MinMaxMetric)) else to_port(b)
            m.update(*args)
            got = m.compute()
            with engine_context(False):
                eager.update(*args)
                want = eager.compute()  # as often as ``m``: MinMaxMetric's compute moves its state
        st = m._epoch.stats
    assert st.fallback_reasons[reason] >= 1, dict(st.fallback_reasons)
    assert st.compute_dispatches == 0
    if reason.endswith(("dense", "fresh")):
        assert st.fallback_reasons["compute:uncompilable-signature"] == len(batches) - 1
    if isinstance(got, dict):
        got, want = tuple(got.values()), tuple(want.values())
    assert_close(got, want, 0.0, msg=reason)


def test_engine_off_computes_eagerly():
    m = tm.MulticlassAccuracy(C, device="cpu")
    m.update(*to_port(tier_batches([16])[0]))
    m.compute()
    assert m._epoch is None or m._epoch.stats.compute_dispatches == 0


_TWO_RANK_BODY = '''
import numpy as np, torch
import torchmetrics_tpu_torch as tm
from torchmetrics_tpu_torch.engine import engine_context

def _batches(rank):
    rng = np.random.RandomState(rank)
    return [(torch.from_numpy(rng.rand(24, 5).astype(np.float32)), torch.from_numpy(rng.randint(0, 5, 24))) for _ in range(3)]

def run(rank):
    out = {}
    with engine_context(True):
        for name, make in (
            ("accuracy", lambda: tm.MulticlassAccuracy(5, device="cpu")),
            ("confmat", lambda: tm.MulticlassConfusionMatrix(5, device="cpu")),
            ("sum", lambda: tm.SumMetric(device="cpu")),
        ):
            m = make()
            for p, t in _batches(rank):
                m.update(p[:, 0]) if name == "sum" else m.update(p, t)
            local = {k: getattr(m, k).clone() for k in m._defaults}
            first = m.compute()
            m._computed = None
            second = m.compute()
            st = m._epoch.stats
            out[name] = {
                "first": first.tolist(), "second": second.tolist(),
                "local_kept": all(torch.equal(getattr(m, k), v) for k, v in local.items()),
                "packed_syncs": st.packed_syncs, "compute_dispatches": st.compute_dispatches,
                "compute_traces": st.compute_traces, "compute_cache_hits": st.compute_cache_hits,
                "fallbacks": dict(st.fallback_reasons),
            }
    return out
'''


def test_fused_sync_and_compute_on_two_ranks(tmp_path):
    results = run_two_ranks(tmp_path, _TWO_RANK_BODY)
    assert all(r["ok"] for r in results), results
    rng_batches = []
    for rank in range(2):
        rng = np.random.RandomState(rank)
        rng_batches.append([(rng.rand(24, 5).astype(np.float32), rng.randint(0, 5, 24)) for _ in range(3)])
    makers = {
        "accuracy": lambda: tm.MulticlassAccuracy(C, device="cpu"),
        "confmat": lambda: tm.MulticlassConfusionMatrix(C, device="cpu"),
        "sum": lambda: tm.SumMetric(device="cpu"),
    }
    for name, make in makers.items():
        ranks = []
        for batches in rng_batches:
            m = make()
            for p, t in batches:
                m.update(torch.from_numpy(p[:, 0])) if name == "sum" else m.update(*to_port((p, t)))
            ranks.append(m)
        ranks[0].merge_state(ranks[1])
        want = ranks[0].compute()
        for rank, res in enumerate(results):
            got = res[name]
            np.testing.assert_allclose(np.asarray(got["first"]), want.numpy(), atol=1e-6, err_msg=f"{name} rank {rank}")
            np.testing.assert_allclose(np.asarray(got["second"]), want.numpy(), atol=1e-6, err_msg=f"{name} rank {rank}")
            assert got["local_kept"], (name, rank)
            assert got["packed_syncs"] == 2 and got["compute_dispatches"] == 2, got
            assert got["compute_traces"] == 1 and got["compute_cache_hits"] == 1, got
            assert not got["fallbacks"], got
