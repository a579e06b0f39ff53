"""The port's compiled update engine (``torchmetrics_tpu_torch/engine/``) against the JAX
package's (``torchmetrics_tpu/engine/``), on the CPU.

Each case of ``tests/test_engine.py`` runs here twice from the same seeded numpy
batches: the JAX package under ``engine_context(True)`` and the port with
its engine forced on (``device="cpu"``, where the engine runs each signature's plain
step on the same static buffers a CUDA graph would use). Values must agree (integer
states exactly, ratios to 1e-6) and so must the counters wherever the mechanisms
correspond: ``traces``, ``cache_hits``, ``dispatches``, ``eager_fallbacks``,
``bucket_pad_rows``, ``bucket_sizes`` and ``metrics_updated``. Reasons are not compared
word for word: the port's guard has no ``TracerBoolConversionError``.

One mapping: the tests run JAX with x64 on, where an int32 state default promotes to
int64 at the first update and the JAX engine traces once more for the new state
dtype (its ``retrace_causes["dtype-change"]``). The port's states keep their dtype,
so there that step is a cache hit; ``jax_counters`` moves those retraces over.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import MetricCollection as JaxMetricCollection
from torchmetrics_tpu import classification as jc
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.metric import Metric as JaxMetric
from tests.torch_parity import assert_states
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch import classification as tc
from torchmetrics_tpu_torch.engine import (
    CompiledUpdate,
    EngineStats,
    engine_context,
    engine_enabled,
    engine_report,
    reset_engine_stats,
    set_engine_enabled,
)
from torchmetrics_tpu_torch.engine import bucketing
from torchmetrics_tpu_torch.engine.compiled import _Guard, _Ineligible, holds_nested_metrics, is_static
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import stat_counts as sc

NUM_CLASSES = 5
RATIO_ATOL = 1e-6  # both sides divide identical integer counts in float32
_COUNTERS = ("traces", "cache_hits", "dispatches", "eager_fallbacks", "bucket_pad_rows", "metrics_updated")


def _batches(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, NUM_CLASSES).astype(np.float32), rng.randint(0, NUM_CLASSES, n)) for n in sizes]


def _t(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _run(metric, batches, conv):
    for b in batches:
        metric.update(*conv(b))
    return np.asarray(metric.compute())


def jax_counters(stats) -> Dict[str, Any]:
    """The JAX engine's counters on the port's terms (see the module docstring)."""
    out = {f: getattr(stats, f) for f in _COUNTERS}
    promoted = stats.retrace_causes.get("dtype-change", 0)
    out["traces"] -= promoted
    out["cache_hits"] += promoted
    out["bucket_sizes"] = set(stats.bucket_sizes)
    return out


def port_counters(stats: EngineStats) -> Dict[str, Any]:
    out = {f: getattr(stats, f) for f in _COUNTERS}
    out["bucket_sizes"] = set(stats.bucket_sizes)
    return out


def _assert_states(port, ref) -> None:
    for attr in ref._defaults:
        np.testing.assert_array_equal(getattr(port, attr).numpy(), np.asarray(getattr(ref, attr)), err_msg=attr)


def _acc(side, **kw):
    return (tc if side == "port" else jc).MulticlassAccuracy(NUM_CLASSES, average="macro", **_dev(side), **kw)


def _dev(side):
    return {"device": "cpu"} if side == "port" else {}


# ---------------------------------------------------------------- retrace counts


def test_fixed_shape_stream_compiles_once():
    """Steady state on fixed shapes is one cached step: after the first, every step is
    a cache hit with zero retraces, on both sides."""
    batches = _batches([32] * 10)
    with jax_engine_context(True, donate=True):
        ref = _acc("jax", validate_args=False)
        want = _run(ref, batches, _j)
    with engine_context(True):
        port = _acc("port", validate_args=False)
        got = _run(port, batches, _t)
    st = port._engine.stats
    assert st.traces == 1 and st.cache_hits == 9 and st.eager_fallbacks == 0
    assert port_counters(st) == jax_counters(ref._engine.stats)
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)
    _assert_states(port, ref)


def test_ragged_stream_stays_within_bucket_budget():
    """Ragged batch sizes ride power-of-two buckets: one signature per bucket, never
    one per distinct size, with the pad rows counted as in the JAX package."""
    sizes = [1, 3, 5, 7, 8, 9, 11, 15, 17, 23, 31, 33, 40, 12, 2, 29]
    buckets = (8, 8, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 16, 8, 32)
    batches = _batches(sizes, seed=1)
    with jax_engine_context(True, donate=True):
        ref = _acc("jax", validate_args=False)
        want = _run(ref, batches, _j)
    with engine_context(True):
        port = _acc("port", validate_args=False)
        got = _run(port, batches, _t)
    st = port._engine.stats
    assert st.traces == 4 and st.bucket_sizes == {8, 16, 32, 64} and st.eager_fallbacks == 0
    assert st.bucket_pad_rows == sum(b - n for n, b in zip(sizes, buckets))
    assert port_counters(st) == jax_counters(ref._engine.stats)
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)
    _assert_states(port, ref)


@pytest.mark.parametrize(
    "sizes", [[9, 17, 5, 32, 1], [3, 64, 7, 7, 30, 33, 1, 16, 100, 2]], ids=["reference", "ragged-stream"]
)
def test_confusion_matrix_bucketed_parity(sizes):
    batches = _batches(sizes, seed=2)
    with jax_engine_context(True, donate=True):
        ref = jc.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False)
        want = _run(ref, batches, _j)
    with engine_context(True):
        port = tc.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device="cpu")
        got = _run(port, batches, _t)
    assert port._engine.stats.eager_fallbacks == 0
    assert port_counters(port._engine.stats) == jax_counters(ref._engine.stats)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- donation safety


def test_donation_correct_after_reset():
    """``reset`` puts fresh defaults on the metric; the first step after it copies them
    into the static buffers (it never writes the registered defaults)."""
    batches = _batches([32] * 3, seed=3)
    with engine_context(True):
        port = _acc("port", validate_args=False)
        _run(port, batches, _t)
        port.reset()
        epoch2 = _run(port, batches, _t)
        assert port._engine.stats.donation_copies >= 4  # 4 states copied in at the epoch start
        assert all(not d.any() for d in port._defaults.values())
    with jax_engine_context(True, donate=True):
        ref = _acc("jax", validate_args=False)
        _run(ref, batches, _j)
        ref.reset()
        want = _run(ref, batches, _j)
    np.testing.assert_allclose(epoch2, want, atol=RATIO_ATOL)
    assert port_counters(port._engine.stats) == jax_counters(ref._engine.stats)


def test_donation_correct_after_clone():
    """``clone`` drops the engine; both halves keep independent, correct state."""
    batches = _batches([32] * 4, seed=4)
    with engine_context(True):
        m = _acc("port", validate_args=False)
        for b in batches[:2]:
            m.update(*_t(b))
        twin = m.clone()
        assert twin._engine is None  # graphs and buffers never travel across clone
        assert not any(is_static(getattr(twin, k)) and getattr(twin, k) is getattr(m, k) for k in m._defaults)
        for b in batches[2:]:
            m.update(*_t(b))
        out_full, out_half = np.asarray(m.compute()), np.asarray(twin.compute())
    with jax_engine_context(True, donate=True):
        ref_full = _run(_acc("jax", validate_args=False), batches, _j)
        ref_half = _run(_acc("jax", validate_args=False), batches[:2], _j)
    np.testing.assert_allclose(out_full, ref_full, atol=RATIO_ATOL)
    np.testing.assert_allclose(out_half, ref_half, atol=RATIO_ATOL)


class _PortHolder(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(NUM_CLASSES), dist_reduce_fx="sum")

    def update(self, p, t):
        self.total = self.total + p.sum(0)

    def compute(self):
        return self.total  # the state tensor itself


class _JaxHolder(JaxMetric):
    full_state_update = False

    def __init__(self):
        super().__init__()
        self.add_state("total", jnp.zeros(NUM_CLASSES), dist_reduce_fx="sum")

    def update(self, p, t):
        self.total = self.total + p.sum(0)

    def compute(self):
        return self.total


@pytest.mark.parametrize("kind", ["holder", "confusion-matrix"])
def test_compute_result_survives_next_update(kind):
    """A ``compute`` value that is a state (or shares its storage) must not change when
    the next replay writes the static buffers in place."""
    batches = _batches([16] * 3, seed=5)

    def make(side):
        if kind == "holder":
            return _PortHolder() if side == "port" else _JaxHolder()
        return (tc if side == "port" else jc).MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, **_dev(side))

    with engine_context(True):
        m = make("port")
        m.update(*_t(batches[0]))
        held = m.compute()
        first = held.clone()
        m.update(*_t(batches[1]))  # writes the static buffers in place
        torch.testing.assert_close(held, first, rtol=0, atol=0)
        later = m.compute()
    with jax_engine_context(True, donate=True):
        ref = make("jax")
        ref.update(*_j(batches[0]))
        want_first = np.asarray(ref.compute())
        ref.update(*_j(batches[1]))
        want_later = np.asarray(ref.compute())
    np.testing.assert_allclose(first.numpy(), want_first, atol=RATIO_ATOL)
    np.testing.assert_allclose(later.numpy(), want_later, atol=RATIO_ATOL)


def test_pickle_drops_engine():
    with engine_context(True):
        m = _acc("port", validate_args=False)
        m.update(*_t(_batches([8], seed=6)[0]))
        assert m._engine is not None
        m2 = pickle.loads(pickle.dumps(m))
        assert m2._engine is None
        np.testing.assert_allclose(np.asarray(m2.compute()), np.asarray(m.compute()), atol=RATIO_ATOL)
        m2.update(*_t(_batches([8], seed=7)[0]))  # the copy builds its own engine
        assert m2._engine is not None and m2._engine is not m._engine


# ---------------------------------------------------------------- fallbacks


def _validating(side, kind):
    mod = tc if side == "port" else jc
    if kind == "accuracy":
        return mod.MulticlassAccuracy(NUM_CLASSES, average="macro", **_dev(side))
    if kind == "confusion-matrix":
        return mod.MulticlassConfusionMatrix(NUM_CLASSES, **_dev(side))
    return mod.MulticlassF1Score(NUM_CLASSES, average="micro", **_dev(side))


@pytest.mark.parametrize("kind", ["accuracy", "confusion-matrix", "f1"])
def test_value_dependent_validation_falls_back(kind):
    """``validate_args=True`` counts unique values on the host (JAX: ``np.unique``, the
    port: ``torch.unique``), which no graph holds: every step falls back, counted."""
    batches = _batches([16] * 3, seed=7)
    with jax_engine_context(True):
        ref = _validating("jax", kind)
        want = _run(ref, batches, _j)
    with engine_context(True):
        port = _validating("port", kind)
        got = _run(port, batches, _t)
    st = port._engine.stats
    assert st.eager_fallbacks == 3 and st.dispatches == 0
    assert any(r.startswith("data-sized-output:_unique") for r in st.fallback_reasons)
    assert port_counters(st) == jax_counters(ref._engine.stats)
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)


def _curve(side, kind):
    mod = tc if side == "port" else jc
    if kind == "multiclass-auroc":
        return mod.MulticlassAUROC(NUM_CLASSES, thresholds=20, validate_args=False, **_dev(side))
    if kind == "binary-auroc":
        return mod.BinaryAUROC(thresholds=20, validate_args=False, **_dev(side))
    return mod.BinaryAveragePrecision(thresholds=20, validate_args=False, **_dev(side))


@pytest.mark.parametrize("kind", ["multiclass-auroc", "binary-auroc", "binary-ap"])
def test_binned_curves_fall_back_like_the_reference(kind):
    """The binned curves check ``bool(all(0 <= preds <= 1))`` on the host before the
    softmax or sigmoid: 3 updates give 3 fallbacks and 0 dispatches on both sides."""
    batches = _batches([32] * 3, seed=8)
    if kind != "multiclass-auroc":
        batches = [(p[:, 0] * 4 - 2, (t > 1).astype(np.int64)) for p, t in batches]  # logits: the sigmoid fires
    with jax_engine_context(True, donate=True):
        ref = _curve("jax", kind)
        want = _run(ref, batches, _j)
    with engine_context(True):
        port = _curve("port", kind)
        got = _run(port, batches, _t)
    st = port._engine.stats
    assert (st.eager_fallbacks, st.dispatches, st.traces) == (3, 0, 0)
    assert st.fallback_reasons["host-read:_local_scalar_dense"] == 1
    assert port_counters(st) == jax_counters(ref._engine.stats)
    np.testing.assert_allclose(got, want, atol=1e-5)  # trapezoid sums in another order


def test_list_state_metric_falls_back():
    rng = np.random.RandomState(8)
    p, t = rng.rand(4, NUM_CLASSES, 6).astype(np.float32), rng.randint(0, NUM_CLASSES, (4, 6))
    with engine_context(True):
        m = tc.MulticlassAccuracy(
            NUM_CLASSES, average="macro", multidim_average="samplewise", validate_args=False, device="cpu"
        )
        m.update(torch.from_numpy(p), torch.from_numpy(t))
        assert m._engine.stats.fallback_reasons.get("list-state") == 1
    with jax_engine_context(True):
        ref = jc.MulticlassAccuracy(NUM_CLASSES, average="macro", multidim_average="samplewise", validate_args=False)
        ref.update(jnp.asarray(p), jnp.asarray(t))
        assert ref._engine.stats.fallback_reasons.get("list-state") == 1
    np.testing.assert_allclose(m.compute().numpy(), np.asarray(ref.compute()), atol=RATIO_ATOL)


class _SideEffect(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.last_batch = None

    def update(self, x):
        self.last_batch = x  # non-state write
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_non_state_side_effect_aborts_compilation():
    """An update that writes a non-state attribute has a side effect a graph would lose:
    it runs eagerly and the side effect happens."""
    with engine_context(True):
        m = _SideEffect()
        x = torch.arange(4.0)
        m.update(x)
        m.update(x + 1)
        assert m._engine.stats.eager_fallbacks == 2
        assert m._engine.stats.dispatches == 0
        assert m.last_batch is not None
        assert float(m.compute()) == float(x.sum() + (x + 1).sum())


class _PortMinMax(Metric):
    """The JAX package's ``MinMaxMetric`` in miniature: a stateless wrapper."""

    full_state_update = True

    def __init__(self, base_metric):
        super().__init__(device="cpu")
        self._base_metric = base_metric
        self.min_val = torch.tensor(float("inf"))
        self.max_val = torch.tensor(float("-inf"))

    def update(self, *args):
        self._base_metric.update(*args)

    def compute(self):
        val = self._base_metric.compute()
        self.max_val = torch.where(self.max_val < val, val, self.max_val)
        self.min_val = torch.where(self.min_val > val, val, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self):
        super().reset()
        self._base_metric.reset()


def test_wrapper_metric_never_compiles_but_inner_does():
    """A wrapper owning an inner metric runs eagerly; the inner metric's own engine still
    builds the real work."""
    from torchmetrics_tpu.wrappers import MinMaxMetric

    batches = _batches([16] * 3, seed=20)
    with engine_context(True):
        inner = _acc("port", validate_args=False)
        wrapped = _PortMinMax(inner)
        vals = [float(wrapped(*_t(b))["raw"]) for b in batches]
        assert wrapped._engine is None or wrapped._engine.stats.dispatches == 0
        assert inner._engine is not None and inner._engine.stats.dispatches > 0
    with jax_engine_context(True, donate=True):
        ref_inner = _acc("jax", validate_args=False)
        ref = MinMaxMetric(ref_inner)
        expected = [float(ref(*_j(b))["raw"]) for b in batches]
        assert port_counters(inner._engine.stats) == jax_counters(ref_inner._engine.stats)
    np.testing.assert_allclose(vals, expected, atol=RATIO_ATOL)


class _StatefulWrapper(Metric):
    full_state_update = False

    def __init__(self, inner):
        super().__init__(device="cpu")
        self.inner = inner
        self.add_state("count", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, p, t):
        self.inner.update(p, t)
        self.count = self.count + 1.0

    def compute(self):
        return self.count


def test_nested_metric_guard():
    """Registered-state wrappers around inner metrics (held in ``_modules`` by
    ``torch.nn.Module``) are detected and demoted."""
    w = _StatefulWrapper(tc.MulticlassAccuracy(NUM_CLASSES, validate_args=False, device="cpu"))
    assert holds_nested_metrics(w)
    assert CompiledUpdate(w)._disabled_reason == "nested-metric"
    with engine_context(True):
        w.update(*_t(_batches([8], seed=21)[0]))
        assert w._engine.stats.fallback_reasons == {"nested-metric": 1}
        assert int(w.inner.update_count) == 1 and float(w.compute()) == 1.0


class _Logger(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.batch_sizes = []

    def update(self, x):
        self.batch_sizes.append(int(x.shape[0]))  # in-place host mutation
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_in_place_container_mutation_aborts_compilation():
    """Appending to a non-state host list inside update demotes to eager, and the
    aborted step's append is rolled back so the eager run does not double it."""
    with engine_context(True):
        m = _Logger()
        m.update(torch.arange(4.0))
        m.update(torch.arange(4.0))
        assert m._engine.stats.dispatches == 0
        assert any("mutates non-state container" in r for r in m._engine.stats.fallback_reasons)
        assert m.batch_sizes == [4, 4]
        assert float(m.compute()) == 12.0


class _DictMut(Metric):
    full_state_update = False

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.info = {"last_n": None}

    def update(self, x):
        self.info["last_n"] = int(x.shape[0])
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


def test_same_length_dict_overwrite_aborts_compilation():
    """A dict value overwrite keeps identity and length; element identity still catches it."""
    with engine_context(True):
        m = _DictMut()
        m.update(torch.arange(4.0))
        m.update(torch.arange(3.0))
        assert m._engine.stats.dispatches == 0
        assert any("mutates non-state container" in r for r in m._engine.stats.fallback_reasons)
        assert m.info["last_n"] == 3
        assert float(m.compute()) == 9.0


def test_compiled_update_kwarg_opt_out():
    with engine_context(True):
        m = _acc("port", validate_args=False, compiled_update=False)
        m.update(*_t(_batches([8], seed=10)[0]))
        assert m._engine is None
    with engine_context(False):
        forced = _acc("port", validate_args=False, compiled_update=True)
        forced.update(*_t(_batches([8], seed=10)[0]))
        assert forced._engine.stats.dispatches == 1


def test_engine_report_aggregates():
    reset_engine_stats()
    with engine_context(True):
        m = _acc("port", validate_args=False)
        for b in _batches([16] * 4, seed=11):
            m.update(*_t(b))
        report = engine_report()
        assert report["engines"] >= 1
        assert report["traces"] >= 1
        assert report["dispatches"] >= 4
        assert engine_report(reset=True)["dispatches"] >= 4
        assert m._engine.stats.dispatches == 0  # reset zeroed every engine's counters


# ---------------------------------------------------------------- fused collections


def _members(side, kinds, validate=False):
    mod = tc if side == "port" else jc
    kw = {"validate_args": validate, **_dev(side)}
    make = {
        "acc_macro": lambda: mod.MulticlassAccuracy(NUM_CLASSES, average="macro", **kw),
        "acc_micro": lambda: mod.MulticlassAccuracy(NUM_CLASSES, average="micro", **kw),
        "prec_macro": lambda: mod.MulticlassPrecision(NUM_CLASSES, average="macro", **kw),
        "cm": lambda: mod.MulticlassConfusionMatrix(NUM_CLASSES, **kw),
        "acc": lambda: mod.MulticlassAccuracy(NUM_CLASSES, average="macro", **kw),
        "auroc": lambda: mod.MulticlassAUROC(NUM_CLASSES, thresholds=20, **kw),
    }
    return {k: make[k]() for k in kinds}


def _collection_parity(port, ref, batches, unfused_kinds, validate=False):
    """Run both collections, then hold every value against the port's collection with
    fusion and groups off (per-metric updates)."""
    for b in batches:
        port.update(*_t(b))
        ref.update(*_j(b))
    out, want = port.compute(), ref.compute()
    plain = MetricCollection(_members("port", unfused_kinds, validate), fused_dispatch=False, compute_groups=False)
    with engine_context(False):
        for b in batches:
            plain.update(*_t(b))
        expected = plain.compute()
    for k in expected:
        np.testing.assert_allclose(out[k].numpy(), expected[k].numpy(), atol=RATIO_ATOL, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    return out


def test_fused_collection_single_dispatch_and_parity():
    """A multi-group collection fuses every group owner's update into ONE step per
    update (one graph replay on the card), and matches per-metric updates."""
    kinds = ["acc_macro", "acc_micro", "prec_macro", "cm"]
    batches = _batches([32] * 6, seed=12)
    with engine_context(True), jax_engine_context(True, donate=True):
        port = MetricCollection(_members("port", kinds))
        ref = JaxMetricCollection(_members("jax", kinds))
        _collection_parity(port, ref, batches, kinds)
        fused = port._fused_engine.stats
        assert (fused.dispatches, fused.metrics_updated, fused.eager_fallbacks) == (6, 18, 0)
        assert port_counters(fused) == jax_counters(ref._fused_engine.stats)
        assert port.compute_groups == ref.compute_groups


def test_fused_collection_ragged_bucket_budget():
    kinds = ["acc_macro", "cm", "acc_micro"]
    batches = _batches([32, 17, 9, 32, 5, 31, 12], seed=13)
    with engine_context(True), jax_engine_context(True, donate=True):
        port = MetricCollection(_members("port", kinds))
        ref = JaxMetricCollection(_members("jax", kinds))
        _collection_parity(port, ref, batches, kinds)
        fused = port._fused_engine.stats
        assert fused.traces == 3 and fused.bucket_sizes == {8, 16, 32}
        assert port_counters(fused) == jax_counters(ref._fused_engine.stats)


def test_fused_collection_survives_bad_member():
    """One member the guard refuses (``validate_args=True``) is excluded; the rest still
    fuse into one step."""
    batches = _batches([32] * 4, seed=22)

    def members(side):
        mod = tc if side == "port" else jc
        d = _dev(side)
        return {
            "acc": mod.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, **d),
            "cm": mod.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, **d),
            "prec_validating": mod.MulticlassPrecision(NUM_CLASSES, average="micro", **d),
        }

    with engine_context(True), jax_engine_context(True, donate=True):
        port, ref = MetricCollection(members("port")), JaxMetricCollection(members("jax"))
        for b in batches:
            port.update(*_t(b))
            ref.update(*_j(b))
        fst = port._fused_engine.stats
        assert (fst.dispatches, fst.metrics_updated) == (4, 8)
        assert any(k.startswith("member:prec_validating:") for k in fst.fallback_reasons)
        assert port_counters(fst) == jax_counters(ref._fused_engine.stats)
        out, want = port.compute(), ref.compute()
    for k in want:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=RATIO_ATOL, err_msg=k)


def _plus_discovery_step(jax_stats, **extra) -> Dict[str, Any]:
    """The JAX engine's counters with the first update added: the JAX collection runs
    it eagerly to discover its groups, where the port's collection, whose members all
    declare a reduction signature, has its groups when built and steps at once."""
    out = jax_counters(jax_stats)
    for key, value in extra.items():
        out[key] += value
    return out


def test_fused_collection_excludes_the_binned_curve():
    """Accuracy, a binned AUROC and a confusion matrix: every member declares a
    reduction signature, so there is no discovery step: three fused steps of the two
    eligible owners, and the curve falls back on its own at every update. The JAX
    package discovers its groups eagerly at the first update and fuses the other two."""
    kinds = ["acc", "auroc", "cm"]
    batches = _batches([32] * 3, seed=25)
    with engine_context(True), jax_engine_context(True, donate=True):
        port = MetricCollection(_members("port", kinds))
        ref = JaxMetricCollection(_members("jax", kinds))
        _collection_parity(port, ref, batches, kinds)
        fst = port._fused_engine.stats
        assert (fst.traces, fst.dispatches, fst.metrics_updated) == (1, 3, 6)
        assert list(fst.fallback_reasons) == ["member:auroc:host-read:_local_scalar_dense"]
        assert port_counters(fst) == _plus_discovery_step(
            ref._fused_engine.stats, cache_hits=1, dispatches=1, metrics_updated=2
        )
        curve, ref_curve = port._modules["auroc"]._engine.stats, ref._modules["auroc"]._engine.stats
        assert (curve.eager_fallbacks, curve.dispatches) == (3, 0)
        assert port_counters(curve) == _plus_discovery_step(ref_curve, eager_fallbacks=1)


def test_fused_collection_honors_per_metric_opt_out():
    with engine_context(True):
        mc = MetricCollection(
            {
                "acc": tc.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu"),
                "cm": tc.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device="cpu"),
                "opted_out": tc.MulticlassAccuracy(
                    NUM_CLASSES, average="micro", validate_args=False, compiled_update=False, device="cpu"
                ),
            }
        )
        for b in _batches([16] * 3, seed=23):
            mc.update(*_t(b))
        assert mc._modules["opted_out"]._engine is None
        fst = mc._fused_engine.stats
        assert fst.dispatches == 3 and fst.metrics_updated == 2 * fst.dispatches


def test_retained_member_handle_stays_valid_after_donated_steps():
    """A group member handle retained across steps keeps reading live state: the views
    re-anchor on the owner's static buffers, which later steps update in place."""
    batches = _batches([16] * 3, seed=24)
    with engine_context(True):
        mc = MetricCollection(
            [
                tc.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu"),
                tc.MulticlassPrecision(NUM_CLASSES, average="macro", validate_args=False, device="cpu"),
            ]
        )
        handle = None
        for b in batches:
            mc.update(*_t(b))
            if handle is None:
                handle = mc["MulticlassPrecision"]
        val = float(handle.compute())
    with jax_engine_context(True, donate=True):
        want = float(_run(jc.MulticlassPrecision(NUM_CLASSES, average="macro"), batches, _j))
    np.testing.assert_allclose(val, want, atol=RATIO_ATOL)


def test_fused_collection_reset_epochs():
    """Fused steps across ``reset`` keep epochs independent and correct."""
    kinds = ["acc", "cm"]
    batches = _batches([16] * 3, seed=14)
    with engine_context(True):
        mc = MetricCollection(_members("port", kinds))
        for b in batches:
            mc.update(*_t(b))
        first = {k: v.clone() for k, v in mc.compute().items()}
        mc.reset()
        for b in batches:
            mc.update(*_t(b))
        second = mc.compute()
        assert mc._fused_engine.stats.dispatches == 6
    with jax_engine_context(True, donate=True):
        ref = JaxMetricCollection(_members("jax", kinds))
        for b in batches:
            ref.update(*_j(b))
        want = ref.compute()
    for k in first:
        np.testing.assert_allclose(second[k].numpy(), first[k].numpy(), atol=RATIO_ATOL, err_msg=k)
        np.testing.assert_allclose(second[k].numpy(), np.asarray(want[k]), atol=RATIO_ATOL, err_msg=k)


def test_fused_collection_clone_is_independent():
    batches = _batches([16] * 2, seed=15)
    with engine_context(True):
        mc = MetricCollection(_members("port", ["acc", "cm"]))
        mc.update(*_t(batches[0]))
        mc.update(*_t(batches[0]))
        twin = mc.clone()
        assert twin._fused_engine is None
        twin.update(*_t(batches[1]))
        out_orig, out_twin = mc.compute(), twin.compute()
    assert not np.allclose(out_orig["cm"].numpy(), out_twin["cm"].numpy())
    np.testing.assert_array_equal(out_orig["cm"].numpy(), 2 * _run(
        tc.MulticlassConfusionMatrix(NUM_CLASSES, device="cpu"), batches[:1], _t
    ))


# ---------------------------------------------------------------- forward, policy, guard


class _PortFullState(_PortHolder):
    full_state_update = True


class _JaxFullState(_JaxHolder):
    full_state_update = True


@pytest.mark.parametrize("path", ["reduce-state", "full-state"])
def test_forward_under_engine(path):
    """``forward`` under the engine: the batch values, the accumulated state and the
    counters agree with the JAX package's; the snapshot ``forward`` keeps is a copy."""
    batches = _batches([32, 32, 17, 32], seed=26)
    with engine_context(True):
        port = _acc("port", validate_args=False) if path == "reduce-state" else _PortFullState()
        got = [port(*_t(b)).numpy() for b in batches]
        got_final = port.compute().numpy()
    with jax_engine_context(True, donate=True):
        ref = _acc("jax", validate_args=False) if path == "reduce-state" else _JaxFullState()
        want = [np.asarray(ref(*_j(b))) for b in batches]
        want_final = np.asarray(ref.compute())
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-5)
    np.testing.assert_allclose(got_final, want_final, atol=1e-5)
    assert port._update_count == len(batches)
    assert port_counters(port._engine.stats) == jax_counters(ref._engine.stats)


def test_engine_policy_resolution(monkeypatch):
    """Auto: on for a CUDA device, off on the CPU; then the environment variable, then
    an override, then the per-metric keyword win in turn."""
    monkeypatch.delenv("TORCHMETRICS_TPU_ENGINE", raising=False)
    assert engine_enabled(torch.device("cuda")) and not engine_enabled(torch.device("cpu"))
    m = _acc("port", validate_args=False)
    m.update(*_t(_batches([8], seed=27)[0]))
    assert m._engine is None  # a CPU metric runs eagerly by default
    monkeypatch.setenv("TORCHMETRICS_TPU_ENGINE", "1")
    assert engine_enabled(torch.device("cpu"))
    with engine_context(False):
        assert not engine_enabled(torch.device("cpu"))
    set_engine_enabled(True)
    try:
        monkeypatch.setenv("TORCHMETRICS_TPU_ENGINE", "0")
        assert engine_enabled(torch.device("cpu"))
    finally:
        set_engine_enabled(None)
    assert not engine_enabled(torch.device("cuda"))
    with pytest.raises(ValueError, match="bool or None"):
        set_engine_enabled("yes")


_REFUSED_UPDATES = {
    "item": lambda x: x.sum().item(),
    "bool": lambda x: bool((x > 0).all()),
    "nonzero": lambda x: x.nonzero(),
    "unique": lambda x: torch.unique(x),
    "bincount": lambda x: torch.bincount(x.long().abs()),
    "boolean-index": lambda x: x[x > 0],
    "masked-select": lambda x: torch.masked_select(x, x > 0),
    "host-tensor": lambda x: x + torch.tensor([1.0]),
    "repeat-interleave": lambda x: torch.repeat_interleave(x.long().abs().clamp(max=2)),
}


@pytest.mark.parametrize("name", sorted(_REFUSED_UPDATES))
def test_guard_refuses_what_no_graph_can_hold(name):
    x = torch.tensor([1.0, -2.0, 3.0])
    with pytest.raises(_Ineligible):
        with _Guard():
            _REFUSED_UPDATES[name](x)


def test_guard_admits_the_eligible_update_bodies():
    """K1's plain version counts with fixed-size scatters (no ``torch.bincount``), so the
    guard admits it on the CPU as the kernel is admitted on the card; and it agrees with
    ``torch.bincount`` counts on invalid, ignored and NaN rows."""
    rng = np.random.RandomState(28)
    preds = torch.from_numpy(rng.randn(64, NUM_CLASSES).astype(np.float32))
    preds[3, 2] = float("nan")
    target = torch.from_numpy(rng.randint(-1, NUM_CLASSES + 1, 64))
    with _Guard():
        got = sc._stat_counts_plain(preds, target, NUM_CLASSES, ignore_index=1)
    valid = (target >= 0) & (target < NUM_CLASSES) & (target != 1)
    am = sc._argmax_nan_first(preds)[valid]
    tv = target[valid]
    want = (
        torch.bincount(am[am == tv], minlength=NUM_CLASSES),
        torch.bincount(am, minlength=NUM_CLASSES),
        torch.bincount(tv, minlength=NUM_CLASSES),
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w.to(torch.int32))


def test_static_buffers_are_shielded_from_every_holder():
    """The metric's states ARE the static buffers after a step; the
    ``sync`` / ``forward`` snapshot copies them, ``compute`` never hands one out, and a
    holder that aliases one (here a registered default) gets a copy before the next step."""
    batches = _batches([16] * 3, seed=29)
    with engine_context(True):
        m = tc.MulticlassConfusionMatrix(NUM_CLASSES, validate_args=False, device="cpu")
        m.update(*_t(batches[0]))
        buf = m._engine._buffers[next(iter(m._engine._buffers))]["confmat"]
        assert m.confmat is buf and is_static(buf)
        refs = m._copy_state_refs()
        assert refs["confmat"] is not buf and torch.equal(refs["confmat"], buf)
        assert m.compute().untyped_storage().data_ptr() != buf.untyped_storage().data_ptr()
        m._defaults["confmat"] = buf  # a holder aliasing the buffer
        before = buf.clone()
        copies = m._engine.stats.donation_copies
        m.update(*_t(batches[1]))
        assert m._engine.stats.donation_copies == copies + 1
        assert m._defaults["confmat"] is not buf and torch.equal(m._defaults["confmat"], before)
        assert m.confmat is buf


def _logit_batches(sizes, labels, seed):
    rng = np.random.RandomState(seed)
    shape = lambda n: (n,) if labels is None else (n, labels)  # noqa: E731
    return [((rng.randn(*shape(n)) * 3).astype(np.float32), rng.randint(0, 2, shape(n))) for n in sizes]


_THRESHOLDED = {
    "binary-accuracy": (lambda mod, thr, d: mod.BinaryAccuracy(threshold=thr, validate_args=False, **d), None),
    "binary-confusion-matrix": (
        lambda mod, thr, d: mod.BinaryConfusionMatrix(threshold=thr, validate_args=False, **d),
        None,
    ),
    "multilabel-confusion-matrix": (
        lambda mod, thr, d: mod.MultilabelConfusionMatrix(3, threshold=thr, validate_args=False, **d),
        3,
    ),
}


@pytest.mark.parametrize("threshold", [0.3, 0.5])
@pytest.mark.parametrize("kind", sorted(_THRESHOLDED))
def test_bucketing_keeps_logit_pad_rows_neutral(kind, threshold):
    """A float batch of logits is sigmoided as a whole, so inside it a zero pad row is
    0.5, a positive under ``threshold=0.3``, while alone it is 0.0, a negative. Below
    0.5 such a batch therefore takes an exact-shape graph; at 0.5 the pad row is a
    negative either way and the batch rides its bucket. Either way the counts equal the
    eager run's and the JAX package's eager run's."""
    make, labels = _THRESHOLDED[kind]
    sizes = [5, 13, 5, 13]
    batches = _logit_batches(sizes, labels, seed=30)
    with engine_context(True):
        port = make(tc, threshold, {"device": "cpu"})
        got = _run(port, batches, _t)
    with engine_context(False):
        eager = _run(make(tc, threshold, {"device": "cpu"}), batches, _t)
    with jax_engine_context(False):
        want = _run(make(jc, threshold, {}), batches, _j)
    np.testing.assert_allclose(got, eager, atol=0)
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)
    st = port._engine.stats
    assert (st.dispatches, st.eager_fallbacks) == (4, 0)
    if threshold < 0.5:
        assert (st.bucketed_steps, st.traces) == (0, 2)  # one exact-shape graph per size
    else:
        assert (st.bucketed_steps, st.bucket_sizes, st.traces) == (4, {8, 16}, 2)


def test_fused_collection_takes_host_inputs():
    """Numpy batches (a data loader's host output) are placed on the owners' device
    before the fused step, as each owner's own update places them, so they still fuse."""
    batches = _batches([16] * 3, seed=31)
    with engine_context(True):
        mc = MetricCollection(_members("port", ["acc", "cm"]))
        for p, t in batches:
            mc.update(p, t)
        fst = mc._fused_engine.stats
        assert (fst.dispatches, fst.eager_fallbacks) == (3, 0)
        out = mc.compute()
    ref = MetricCollection(_members("port", ["acc", "cm"]))
    for b in batches:
        ref.update(*_t(b))
    want = ref.compute()
    for k in want:
        np.testing.assert_array_equal(out[k].numpy(), want[k].numpy(), err_msg=k)


def test_bucketing_helpers():
    assert [bucketing.next_bucket(n) for n in (1, 8, 9, 100)] == [8, 8, 16, 128]
    assert bucketing.batch_size([torch.zeros(3, 2), torch.zeros(3)]) == 3
    assert bucketing.batch_size([torch.zeros(3, 2), torch.zeros(4)]) is None
    assert bucketing.bucket_eligible(tc.MulticlassConfusionMatrix(3, device="cpu"))
    assert not bucketing.bucket_eligible(tc.MulticlassAUROC(3, thresholds=5, device="cpu"))
    assert not bucketing.bucket_eligible(
        tc.MulticlassAccuracy(3, multidim_average="samplewise", device="cpu")
    )  # cat lists are not sum-reduced
    rows = bucketing.pad_row_constants([torch.ones(5, 3, dtype=torch.int64), torch.tensor(2.0)])
    assert rows[0].shape == (1, 3) and rows[0].dtype == torch.int64 and not rows[0].any() and rows[1] is None



def test_inputs_a_graph_cannot_take_fall_back():
    """A non-tensor input, or one that records a gradient, keeps the eager path."""

    class Scaled(_PortHolder):
        def update(self, p, scale):
            self.total = self.total + p.sum(0) * scale

    p = torch.ones(4, NUM_CLASSES)
    with engine_context(True):
        m = Scaled()
        m.update(p, 2.0)
        m.update(p.requires_grad_(), torch.tensor(1.0))
        with torch.no_grad():
            m.update(p, torch.tensor(1.0))
        assert dict(m._engine.stats.fallback_reasons) == {"non-tensor-input": 1, "grad-input": 1}
        assert m._engine.stats.dispatches == 1
        assert m.compute().tolist() == [16.0] * NUM_CLASSES


# ---------------------------------------------------------------- the rest of the stat-scores family

# kind -> (constructor over a module, input kind, expected split on the port's engine:
# "replay" runs every update as its graph step, "fallback" runs every update eagerly)
_FAMILY = {
    "multiclass-specificity": (lambda m, d: m.MulticlassSpecificity(NUM_CLASSES, average="macro", **d), "mc", "replay"),
    "multiclass-hamming": (lambda m, d: m.MulticlassHammingDistance(NUM_CLASSES, average="weighted", **d), "mc", "replay"),
    "multiclass-specificity-top2": (
        lambda m, d: m.MulticlassSpecificity(NUM_CLASSES, top_k=2, average="none", **d), "mc", "replay"
    ),
    "binary-specificity": (lambda m, d: m.BinarySpecificity(**d), "bin", "replay"),
    "multilabel-hamming": (lambda m, d: m.MultilabelHammingDistance(3, average="micro", **d), "ml", "replay"),
    "multiclass-jaccard": (lambda m, d: m.MulticlassJaccardIndex(NUM_CLASSES, **d), "mc", "replay"),
    "multiclass-mcc": (lambda m, d: m.MulticlassMatthewsCorrCoef(NUM_CLASSES, **d), "mc", "replay"),
    "multiclass-kappa": (lambda m, d: m.MulticlassCohenKappa(NUM_CLASSES, weights="quadratic", **d), "mc", "replay"),
    "binary-jaccard": (lambda m, d: m.BinaryJaccardIndex(**d), "bin", "replay"),
    "multilabel-mcc": (lambda m, d: m.MultilabelMatthewsCorrCoef(3, **d), "ml", "replay"),
    "multilabel-exact-match": (lambda m, d: m.MultilabelExactMatch(3, **d), "ml", "replay"),
    "multiclass-exact-match": (lambda m, d: m.MulticlassExactMatch(NUM_CLASSES, **d), "mc", "replay"),
    "multilabel-exact-match-samplewise": (
        lambda m, d: m.MultilabelExactMatch(3, multidim_average="samplewise", **d), "ml3", "fallback"
    ),
    "multiclass-recall-at-precision": (
        lambda m, d: m.MulticlassRecallAtFixedPrecision(NUM_CLASSES, min_precision=0.5, thresholds=20, **d),
        "mc",
        "fallback",
    ),
    "binary-precision-at-recall": (
        lambda m, d: m.BinaryPrecisionAtFixedRecall(min_recall=0.5, thresholds=20, **d), "bin", "fallback"
    ),
    "multilabel-specificity-at-sensitivity": (
        lambda m, d: m.MultilabelSpecificityAtSensitivity(3, min_sensitivity=0.5, thresholds=20, **d),
        "ml",
        "fallback",
    ),
}


def _family_batches(inputs: str, sizes, seed: int):
    """Probabilities for multiclass, logits (a sigmoid) for binary and multilabel."""
    if inputs == "mc":
        return _batches(sizes, seed)
    rng = np.random.RandomState(seed)
    shape = {"bin": lambda n: (n,), "ml": lambda n: (n, 3), "ml3": lambda n: (n, 3, 4)}[inputs]
    return [((rng.randn(*shape(n)) * 2).astype(np.float32), rng.randint(0, 2, shape(n))) for n in sizes]


def _family_value(value):
    return tuple(np.asarray(v) for v in value) if isinstance(value, tuple) else np.asarray(value)


@pytest.mark.parametrize("kind", sorted(_FAMILY))
def test_family_replay_and_fallback_split(kind):
    """Each new family on the engine against its eager run and the JAX package's engine:
    the stat-scores and confusion-matrix derivatives and global exact match replay, the
    fixed-point curves fall back on every update (their range check reads the host),
    samplewise exact match falls back on its list state; the counters equal the JAX
    engine's."""
    make, inputs, split = _FAMILY[kind]
    batches = _family_batches(inputs, [32, 32, 17, 32, 9], seed=40)
    with engine_context(True):
        port = make(tc, {"validate_args": False, "device": "cpu"})
        for b in batches:
            port.update(*_t(b))
        got = port.compute()
    with engine_context(False):
        eager = make(tc, {"validate_args": False, "device": "cpu"})
        for b in batches:
            eager.update(*_t(b))
        want_eager = eager.compute()
    with jax_engine_context(True, donate=True):
        ref = make(jc, {"validate_args": False})
        for b in batches:
            ref.update(*_j(b))
        want = ref.compute()
    st = port._engine.stats
    if split == "replay":
        assert st.eager_fallbacks == 0 and st.dispatches == len(batches)
    else:
        assert st.eager_fallbacks == len(batches) and st.dispatches == 0
    assert port_counters(st) == jax_counters(ref._engine.stats)
    for g, e, w in zip(*(v if isinstance(v, tuple) else (v,) for v in (got, want_eager, want))):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(e))
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=RATIO_ATOL, rtol=2e-6)
    assert_states(port, ref)


def _family_members(side, validate=False):
    mod = tc if side == "port" else jc
    kw = {"validate_args": validate, **_dev(side)}
    return {
        "acc": mod.MulticlassAccuracy(NUM_CLASSES, average="macro", **kw),
        "spec": mod.MulticlassSpecificity(NUM_CLASSES, average="macro", **kw),
        "hamming": mod.MulticlassHammingDistance(NUM_CLASSES, average="macro", **kw),
        "iou": mod.MulticlassJaccardIndex(NUM_CLASSES, **kw),
        "mcc": mod.MulticlassMatthewsCorrCoef(NUM_CLASSES, **kw),
        "kappa": mod.MulticlassCohenKappa(NUM_CLASSES, weights="quadratic", **kw),
    }


@pytest.mark.parametrize("sizes", [[32] * 4, [32, 17, 9, 32, 5]], ids=["fixed", "ragged"])
def test_family_collection_fuses_both_groups(sizes):
    """Accuracy, specificity and Hamming distance (one stat-scores group) and Jaccard,
    MCC and kappa (one confusion-matrix group): one fused step per update, the values
    of the members run one by one, and the JAX package's groups and counters."""
    batches = _batches(sizes, seed=41)
    with engine_context(True), jax_engine_context(True, donate=True):
        port = MetricCollection(_family_members("port"))
        ref = JaxMetricCollection(_family_members("jax"))
        assert sorted(map(sorted, port.compute_groups.values())) == [["acc", "hamming", "spec"], ["iou", "kappa", "mcc"]]
        for b in batches:
            port.update(*_t(b))
            ref.update(*_j(b))
        fst = port._fused_engine.stats
        assert (fst.dispatches, fst.eager_fallbacks, fst.metrics_updated) == (len(sizes), 0, 2 * len(sizes))
        assert port_counters(fst) == jax_counters(ref._fused_engine.stats)
        assert port.compute_groups == ref.compute_groups
        out, want = port.compute(), ref.compute()
    plain = MetricCollection(_family_members("port"), fused_dispatch=False, compute_groups=False)
    with engine_context(False):
        for b in batches:
            plain.update(*_t(b))
        expected = plain.compute()
    for k in expected:
        np.testing.assert_array_equal(out[k].numpy(), expected[k].numpy(), err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=RATIO_ATOL, rtol=2e-6, err_msg=k)


_FAMILY_THRESHOLDED = {
    "binary-specificity": (lambda mod, thr, d: mod.BinarySpecificity(threshold=thr, validate_args=False, **d), None),
    "binary-jaccard": (lambda mod, thr, d: mod.BinaryJaccardIndex(threshold=thr, validate_args=False, **d), None),
    "multilabel-hamming": (
        lambda mod, thr, d: mod.MultilabelHammingDistance(3, threshold=thr, validate_args=False, **d),
        3,
    ),
    "multilabel-mcc": (
        lambda mod, thr, d: mod.MultilabelMatthewsCorrCoef(3, threshold=thr, validate_args=False, **d),
        3,
    ),
    "multilabel-exact-match": (
        lambda mod, thr, d: mod.MultilabelExactMatch(3, threshold=thr, validate_args=False, **d),
        3,
    ),
}


@pytest.mark.parametrize("threshold", [0.3, 0.5])
@pytest.mark.parametrize("kind", sorted(_FAMILY_THRESHOLDED))
def test_family_ragged_logits_at_both_thresholds(kind, threshold):
    """Ragged logits at thresholds 0.3 and 0.5: the engine's counts equal the eager
    run's exactly and the JAX package's eager run's values, whichever way the batch is
    bucketed (exact shapes under 0.5, where a zero pad row would count as a positive)."""
    make, labels = _FAMILY_THRESHOLDED[kind]
    batches = _logit_batches([5, 13, 5, 13], labels, seed=42)
    with engine_context(True):
        port = make(tc, threshold, {"device": "cpu"})
        got = _run(port, batches, _t)
    with engine_context(False):
        eager_metric = make(tc, threshold, {"device": "cpu"})
        eager = _run(eager_metric, batches, _t)
    with jax_engine_context(False):
        want = _run(make(jc, threshold, {}), batches, _j)
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL)
    for attr in port._defaults:
        np.testing.assert_array_equal(getattr(port, attr).numpy(), getattr(eager_metric, attr).numpy(), err_msg=attr)
    st = port._engine.stats
    assert (st.dispatches, st.eager_fallbacks) == (4, 0)
