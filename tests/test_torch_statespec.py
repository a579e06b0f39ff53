"""The ``StateSpec`` registry (``engine/statespec.py``) against the JAX package's.

Mirrors ``tests/test_statespec.py``: ``add_state`` registers one frozen spec per state
and the consumers read it (zero derived specs in-tree), a state registered without
``add_state`` derives its spec once (counted, recorded, exported), the serving roles are
first-class, the rider keys stay in lockstep, the shard rules validate at registration,
and the specs survive a pickle. The registered specs of the classes that declare shard
rules are held field by field against the JAX package's.
"""

from __future__ import annotations

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification  # noqa: F401  (jtm.classification)
import torchmetrics_tpu.detection.ingraph as jingraph
import torchmetrics_tpu.image  # noqa: F401  (jtm.image)
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.engine import statespec as jstatespec
from torchmetrics_tpu_torch.engine import statespec
from torchmetrics_tpu_torch.engine.stats import engine_report, reset_engine_stats
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

NUM_CLASSES = 8


def _strip_registry(metric):
    """An out-of-tree metric in all but name: no registered specs."""
    metric._state_specs.clear()
    return metric


class RichStates(Metric):
    """Every fold kind the packed plan supports, through ``add_state``."""

    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", torch.zeros(NUM_CLASSES), dist_reduce_fx="sum")
        self.add_state("avg", torch.tensor(0.0), dist_reduce_fx="mean")
        self.add_state("peak", torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("trough", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("raw", torch.zeros(2), dist_reduce_fx=None)
        self.add_state("rows", torch.zeros(3, 2), dist_reduce_fx="cat")

    def update(self, x):
        self.total = self.total + x.sum(0)
        self.avg = x.mean()
        self.peak = torch.maximum(self.peak, x.max())
        self.trough = torch.minimum(self.trough, x.min())
        self.raw = self.raw + torch.stack([x.sum(), torch.tensor(float(x.numel()))])
        self.rows = x[:3, :2]

    def compute(self):
        return self.total.sum() + self.avg + self.peak + self.trough


_FIELDS = ("fold", "role", "dtype_policy", "row_additive", "state_additive", "pad_exempt", "rank_invariant", "hh", "shard_rule")


def _ext_t(x):
    return x.to(torch.float32).reshape(x.shape[0], -1)[:, :16]


def _ext_j(x):
    return x.astype(jnp.float32).reshape(x.shape[0], -1)[:, :16]


PAIRS = {
    "accuracy": (
        lambda: ttm.MulticlassAccuracy(NUM_CLASSES, device="cpu"),
        lambda: jtm.classification.MulticlassAccuracy(NUM_CLASSES),
    ),
    "confmat": (
        lambda: ttm.MulticlassConfusionMatrix(NUM_CLASSES, device="cpu"),
        lambda: jtm.classification.MulticlassConfusionMatrix(NUM_CLASSES),
    ),
    "multilabel_confmat": (
        lambda: ttm.MultilabelConfusionMatrix(NUM_CLASSES, device="cpu"),
        lambda: jtm.classification.MultilabelConfusionMatrix(NUM_CLASSES),
    ),
    "binary_confmat": (
        lambda: ttm.BinaryConfusionMatrix(device="cpu"),
        lambda: jtm.classification.BinaryConfusionMatrix(),
    ),
    "fid": (
        lambda: ttm.image.FrechetInceptionDistance(_ext_t, num_features=16, device="cpu"),
        lambda: jtm.image.FrechetInceptionDistance(_ext_j, num_features=16),
    ),
    "packed_map": (
        lambda: ttm.detection.PackedMeanAveragePrecision(num_classes=NUM_CLASSES, device="cpu"),
        lambda: jingraph.PackedMeanAveragePrecision(num_classes=NUM_CLASSES),
    ),
    "sum": (lambda: ttm.SumMetric(nan_strategy=0.0, device="cpu"), lambda: jtm.SumMetric(nan_strategy=0.0)),
    "mean": (lambda: ttm.MeanMetric(device="cpu"), lambda: jtm.MeanMetric()),
}


@pytest.mark.parametrize("name", list(PAIRS))
def test_registered_specs_equal_jax(name):
    """Field by field: the same folds, roles, additivity, rank invariance and rules."""
    port, ref = PAIRS[name][0](), PAIRS[name][1]()
    ps, js = port.state_specs(), ref.state_specs()
    assert list(ps) == list(js)
    for k in ps:
        for field in _FIELDS:
            assert getattr(ps[k], field) == getattr(js[k], field), (name, k, field)
        assert ps[k].fold_fn is None and js[k].fold_fn is None or ps[k].fold == "custom"


def test_add_state_registers_specs_zero_fallbacks():
    reset_engine_stats()
    m = ttm.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu")
    specs = m.state_specs()
    assert set(specs) == {"tp", "fp", "tn", "fn"}
    for sp in specs.values():
        assert sp.fold == "sum" and sp.role == "state"
        assert sp.row_additive and not sp.state_additive
        assert sp.shard_rule == "class_axis"
        assert statespec.resolve_shard_rule(sp) is None  # no mesh: replicated
    assert ttm.SumMetric(nan_strategy=0.0, device="cpu").state_specs()["value"].state_additive
    assert statespec.spec_fallback_count() == 0


def test_serve_roles_registered_first_class():
    from torchmetrics_tpu_torch.serve.sketch import HeavyHitters
    from torchmetrics_tpu_torch.serve.window import WindowedMetric

    reset_engine_stats()
    hh = HeavyHitters(k=4, device="cpu")
    specs = hh.state_specs()
    assert specs["cms"].role == "hh-grid"
    assert specs["hh_ids"].role == "hh-ids"
    assert specs["hh_ids"].hh == ("cms", 4, 4, 2048)
    assert specs["hh_counts"].role == "hh-counts"
    w = WindowedMetric(ttm.SumMetric(nan_strategy=0.0, device="cpu"), buckets=4, bucket_size=2)
    assert w.state_specs()["clock"].role == "ring-clock"
    plan = PackedSyncPlan([("hh", hh)], 1, None)
    assert [sp.kind for sp in plan.specs] == ["sum", "hh-ids", "hh-counts"]
    assert statespec.spec_fallback_count() == 0


def test_legacy_derivation_counts_fallback_once():
    from torchmetrics_tpu_torch.diag import diag_context

    reset_engine_stats()
    m = _strip_registry(ttm.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu"))
    with diag_context() as rec:
        sp = statespec.spec_of(m, "tp", consumer="unit-test")
    assert sp.fold == "sum" and sp.row_additive and sp.shard_rule == "class_axis"
    assert statespec.spec_fallback_count() == 1
    statespec.spec_of(m, "tp", consumer="unit-test")  # cached back: counted once
    assert statespec.spec_fallback_count() == 1 == engine_report()["spec_fallbacks"]
    events = [e for e in rec.snapshot() if e.kind == "spec.fallback"]
    assert events and events[0].data["state"] == "tp" and events[0].data["consumer"] == "unit-test"


def test_spec_fallback_prometheus_series():
    from torchmetrics_tpu_torch.diag import export_prometheus

    reset_engine_stats()
    legacy = _strip_registry(ttm.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu"))
    statespec.spec_of(legacy, "tp", consumer="test")
    line = next(ln for ln in export_prometheus().splitlines() if ln.startswith("tm_tpu_spec_fallbacks_total"))
    assert float(line.split()[-1]) >= 1.0


def test_legacy_hh_derivation_matches_registered_plan():
    from torchmetrics_tpu_torch.serve.sketch import HeavyHitters

    reset_engine_stats()
    registered = HeavyHitters(k=4, device="cpu")
    legacy = _strip_registry(HeavyHitters(k=4, device="cpu"))
    legacy._hh_fold_info = {"ids": "hh_ids", "counts": "hh_counts", "cms": "cms", "k": 4, "depth": 4, "width": 2048}
    plan_r = PackedSyncPlan([("m", registered)], 1, None)
    plan_l = PackedSyncPlan([("m", legacy)], 1, None)
    assert [(s.attr, s.kind, s.hh_meta) for s in plan_r.specs] == [(s.attr, s.kind, s.hh_meta) for s in plan_l.specs]
    assert statespec.spec_fallback_count() > 0


def test_plan_parity_spec_vs_legacy_all_roles():
    reset_engine_stats()
    registered, legacy = RichStates(), _strip_registry(RichStates())
    x = torch.as_tensor(np.random.RandomState(3).rand(4, NUM_CLASSES), dtype=torch.float32)
    registered.update(x)
    legacy.update(x)
    plan_r = PackedSyncPlan([("m", registered)], 2, None)
    plan_l = PackedSyncPlan([("m", legacy)], 2, None)
    assert plan_r.signature() == plan_l.signature()
    assert [s.kind for s in plan_r.specs] == ["sum", "mean", "max", "min", "none-array", "cat"]
    assert statespec.spec_fallback_count() == len(legacy._reductions)


def test_loose_readers_read_the_registry():
    """``state_fold``, ``row_additive`` and ``state_role`` answer from the spec."""
    m = RichStates()
    assert statespec.state_fold(m, "peak") == ("max", None)
    assert not statespec.row_additive(m, "total")
    assert statespec.state_role(m, "total") is None
    m._state_specs["total"] = dataclasses.replace(m._state_specs["total"], row_additive=True, role="ring-clock")
    assert statespec.row_additive(m, "total") and statespec.state_role(m, "total") == "ring-clock"


def test_add_state_takes_a_ready_spec_and_validates():
    class Custom(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            spec = statespec.StateSpec(name="other", fold="sum", shard_rule="row_sharded")
            self.add_state("x", torch.zeros(4), "sum", spec=spec)

        def update(self):
            pass

        def compute(self):
            return self.x

    sp = Custom().state_specs()["x"]
    assert sp.name == "x" and sp.shard_rule == "row_sharded"
    with pytest.raises(ValueError, match="unknown StateSpec field"):
        statespec.build_spec(object(), "x", None, {"banana": 1})
    with pytest.raises(ValueError, match="must not rename"):
        statespec.build_spec(object(), "x", None, {"name": "y"})
    with pytest.raises(ValueError, match="registered rules"):
        statespec.build_spec(object(), "x", None, {"shard_rule": "nope"})


def test_rider_keys_lockstep():
    from torchmetrics_tpu_torch.diag import sentinel as _sentinel
    from torchmetrics_tpu_torch.engine import numerics as _numerics
    from torchmetrics_tpu_torch.engine import txn as _txn

    assert statespec.RIDER_KEYS == {_sentinel.STATE_KEY, _txn.STATE_KEY, _numerics.STATE_KEY} == jstatespec.RIDER_KEYS
    assert statespec.PAD_EXEMPT_KEYS == statespec.RIDER_KEYS


def test_shard_rule_noop_default():
    sp = ttm.SumMetric(nan_strategy=0.0, device="cpu").state_specs()["value"]
    assert sp.shard_rule == "replicate"
    assert statespec.resolve_shard_rule(sp) is None
    with pytest.raises(ValueError, match="unknown shard rule"):
        statespec.resolve_shard_rule(dataclasses.replace(sp, shard_rule="nope"))
    assert set(statespec.SHARD_RULES) == set(jstatespec.SHARD_RULES)


def test_specs_pickle_with_the_metric():
    m = ttm.MulticlassAccuracy(NUM_CLASSES, average="macro", validate_args=False, device="cpu")
    clone = pickle.loads(pickle.dumps(m))
    assert set(clone._state_specs) == {"tp", "fp", "tn", "fn"}
    assert clone._state_specs["tp"] == m._state_specs["tp"]
