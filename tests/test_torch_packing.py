"""The packed sync: ``parallel/packing.PackedSyncPlan`` and ``engine/epoch``, against the JAX package.

- Plan level, world 2 with genuinely different replicas (as
  ``tests/test_epoch_engine.py::test_packed_ragged_cat_plan_level`` does for the JAX
  package): sum / mean / max / min states, a custom fold, a ``None``-stacked tensor,
  a ragged ``cat`` list and a ``None`` list. The port's buffer keys, rank invariance
  and packed buffers equal the JAX plan's; the fold of the stacked buffers equals the
  JAX fold and the port's own ``merge_state`` (integers exactly, floats to 1e-6).
- A one-process world syncs through the plan with zero collectives and leaves the
  states the eager sync leaves.
- Two gloo processes: a collection's ``compute()`` takes the packed route, issues one
  collective per buffer plus the metadata gather, and its values equal the
  ``merge_state`` fold of the two ranks' states.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_sync_guard import run_two_ranks
from torchmetrics_tpu.metric import Metric as JaxMetric
from torchmetrics_tpu.parallel.packing import PackedSyncPlan as JaxPackedSyncPlan
from torchmetrics_tpu_torch import Metric, MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan, PackingError

K = 4


def _jax_prod(s):
    return jnp.prod(s, axis=0)


def _torch_prod(s):
    return torch.prod(s, dim=0)


class JaxRich(JaxMetric):
    """Every fold kind the plan supports, with explicit 32-bit dtypes."""

    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", jnp.zeros(K, dtype=jnp.float32), dist_reduce_fx="sum")
        self.add_state("count", jnp.zeros((), dtype=jnp.int32), dist_reduce_fx="sum")
        self.add_state("avg", jnp.zeros((), dtype=jnp.float32), dist_reduce_fx="mean")
        self.add_state("peak", jnp.full((), -jnp.inf, dtype=jnp.float32), dist_reduce_fx="max")
        self.add_state("trough", jnp.full((), jnp.inf, dtype=jnp.float32), dist_reduce_fx="min")
        self.add_state("raw", jnp.zeros((2,), dtype=jnp.float32), dist_reduce_fx=None)
        self.add_state("tail", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")
        self.add_state("packs", [], dist_reduce_fx=None)
        self.add_state("prod", jnp.ones((), dtype=jnp.float32), dist_reduce_fx=_jax_prod)

    def update(self, x, y):
        self.total = self.total + x.sum(0)
        self.count = self.count + jnp.int32(x.shape[0])
        self.avg = x.mean()
        self.peak = jnp.maximum(self.peak, x.max())
        self.trough = jnp.minimum(self.trough, x.min())
        self.raw = x.sum(0)[:2]
        self.tail.append(x[:, 0])
        self.labels.append(y)
        self.packs.append(x[:2])
        self.prod = self.prod * jnp.float32(1.5)

    def compute(self):
        return self.total.sum() + self.avg


class TorchRich(Metric):
    """The port's twin of ``JaxRich``."""

    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", torch.zeros(K, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("avg", torch.zeros((), dtype=torch.float32), dist_reduce_fx="mean")
        self.add_state("peak", torch.full((), -float("inf")), dist_reduce_fx="max")
        self.add_state("trough", torch.full((), float("inf")), dist_reduce_fx="min")
        self.add_state("raw", torch.zeros((2,), dtype=torch.float32), dist_reduce_fx=None)
        self.add_state("tail", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")
        self.add_state("packs", [], dist_reduce_fx=None)
        self.add_state("prod", torch.ones((), dtype=torch.float32), dist_reduce_fx=_torch_prod)

    def update(self, x, y):
        self.total = self.total + x.sum(0)
        self.count = self.count + x.shape[0]
        self.avg = x.mean()
        self.peak = torch.maximum(self.peak, x.max())
        self.trough = torch.minimum(self.trough, x.min())
        self.raw = x.sum(0)[:2]
        self.tail.append(x[:, 0])
        self.labels.append(y)
        self.packs.append(x[:2])
        self.prod = self.prod * 1.5

    def compute(self):
        return self.total.sum() + self.avg


def _replica_inputs(seed: int, rows: int):
    rng = np.random.default_rng(seed)
    return rng.random((rows, K)).astype(np.float32), rng.integers(0, 9, rows).astype(np.int32)


def _replicas(rows_a: int, rows_b: int):
    """Two ranks with different data and a different number of rows (ragged cat)."""
    (xa, ya), (xb, yb) = _replica_inputs(0, rows_a), _replica_inputs(1, rows_b)
    ja, jb, ta, tb = JaxRich(), JaxRich(), TorchRich(), TorchRich()
    ja.update(jnp.asarray(xa), jnp.asarray(ya))
    jb.update(jnp.asarray(xb), jnp.asarray(yb))
    ta.update(torch.from_numpy(xa), torch.from_numpy(ya))
    tb.update(torch.from_numpy(xb), torch.from_numpy(yb))
    return ja, jb, ta, tb


def _fold_world2(plan_cls, a, b, stack, fold_runner):
    plan_a, plan_b = plan_cls([("", a)], world_size=2), plan_cls([("", b)], world_size=2)
    meta = np.stack([plan_a.metadata_local(), plan_b.metadata_local()])
    plan_a.finalize(meta)
    plan_b.finalize(meta)
    bufs_a, bufs_b = plan_a.pack(), plan_b.pack()
    gathered = {k: stack([bufs_a[k], bufs_b[k]]) for k in bufs_a}
    return plan_a, bufs_a, fold_runner(plan_a.make_fold())(gathered)[""]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal_states(got: dict, want: dict) -> None:
    for attr, w in want.items():
        g = got[attr]
        if isinstance(w, list):
            assert isinstance(g, list) and len(g) == len(w), attr
            pairs = list(zip(g, w))
        else:
            pairs = [(g, w)]
        for x, y in pairs:
            x, y = _np(x), _np(y)
            if y.dtype.kind in "iu":
                np.testing.assert_array_equal(x, y, err_msg=attr)
            else:
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-6, err_msg=attr)


@pytest.mark.parametrize(("rows_a", "rows_b"), [(3, 5), (6, 2), (4, 4)])
def test_plan_world2_matches_jax_fold_and_merge_state(rows_a, rows_b):
    ja, jb, ta, tb = _replicas(rows_a, rows_b)
    jplan, jbufs, jout = _fold_world2(JaxPackedSyncPlan, ja, jb, jnp.stack, jax.jit)
    tplan, tbufs, tout = _fold_world2(PackedSyncPlan, ta, tb, torch.stack, lambda f: f)

    assert tplan.buffer_keys() == jplan.buffer_keys() == ["gather:float32", "gather:int32", "reduce:float32", "reduce:int32"]
    assert tplan.rank_invariant is jplan.rank_invariant is False
    # the same layout; float states were summed by two frameworks (an ulp apart)
    assert sorted(tbufs) == sorted(jbufs)
    _assert_equal_states(tbufs, {k: np.asarray(v) for k, v in jbufs.items()})

    # the fold equals the JAX fold ...
    assert sorted(tout) == sorted(jout)
    _assert_equal_states(tout, jout)
    assert tout["raw"].shape == (2, 2) and tplan.none_folded_attrs("") == ["raw"]
    # ... and the port's merge_state of the same replicas
    ta.merge_state(tb)
    merged = {attr: getattr(ta, attr) for attr in ta._defaults}
    merged["tail"] = [torch.cat(merged["tail"])]
    merged["labels"] = [torch.cat(merged["labels"])]
    tout_lists = dict(tout, tail=[tout["tail"]], labels=[tout["labels"]])
    _assert_equal_states(tout_lists, merged)


def test_fixed_shape_plan_is_rank_invariant_like_jax():
    import torchmetrics_tpu.classification as jc

    rng = np.random.default_rng(3)
    preds, target = rng.standard_normal((32, 5)).astype(np.float32), rng.integers(0, 5, 32)
    port = MulticlassAccuracy(num_classes=5, device="cpu")
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    tplan = PackedSyncPlan([("", port)], 2)
    # the JAX package's counters are int32 in its default 32-bit mode (the test
    # conftest turns 64-bit mode on, which widens them)
    with jax.enable_x64(False):
        ref = jc.MulticlassAccuracy(num_classes=5)
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        jplan = JaxPackedSyncPlan([("", ref)], 2)
        assert tplan.rank_invariant and jplan.rank_invariant
        assert tplan.metadata_local() is None and jplan.metadata_local() is None
        tplan.finalize(None)
        jplan.finalize(None)
        assert tplan.buffer_keys() == jplan.buffer_keys() == ["reduce:int32"]


def test_unpackable_layouts_raise_packing_error():
    class HostList(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("items", [], dist_reduce_fx="cat")

        def update(self, x):
            self.items.append(x)

        def compute(self):
            return self.items

    m = HostList()
    m.items.append("not a tensor")
    with pytest.raises(PackingError, match="host objects"):
        PackedSyncPlan([("", m)], 2)


def test_world1_packed_sync_issues_no_collective_and_equals_eager():
    """One process: the packed route folds ``local[None]`` and leaves exactly the
    states the eager per-tensor sync leaves; ``unsync`` restores the local ones."""
    x, y = _replica_inputs(5, 6)
    packed, eager = TorchRich(distributed_available_fn=lambda: True), TorchRich(distributed_available_fn=lambda: True)
    for m in (packed, eager):
        m.update(torch.from_numpy(x), torch.from_numpy(y))
    local = {a: getattr(packed, a) for a in packed._defaults}
    eager.sync(dist_sync_fn=lambda t, group=None: [t])
    packed.sync()
    stats = packed._epoch.stats
    assert (stats.packed_syncs, stats.sync_collectives, stats.eager_fallbacks) == (1, 0, 0)
    assert eager._epoch.stats.fallback_reasons == {"sync:custom-dist-sync-fn": 1}
    want = {a: getattr(eager, a) for a in eager._defaults}
    got = {a: getattr(packed, a) for a in packed._defaults}
    want["tail"], want["labels"] = [want["tail"]], [want["labels"]]
    got["tail"], got["labels"] = [got["tail"]], [got["labels"]]
    _assert_equal_states(got, want)
    assert packed._none_folded == eager._none_folded == {"raw"}
    packed.unsync()
    _assert_equal_states({a: getattr(packed, a) for a in packed._defaults}, local)


def test_world1_collection_compute_takes_one_packed_sync():
    def member(**kw):
        return MulticlassAccuracy(num_classes=5, device="cpu", distributed_available_fn=lambda: True, **kw)

    mc = MetricCollection({"a": member(), "b": member(average="micro"), "c": member(ignore_index=0)})
    rng = np.random.default_rng(9)
    for _ in range(3):
        mc.update(torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32)), torch.from_numpy(rng.integers(0, 5, 16)))
    local = {name: m.tp.clone() for name, m in mc.items(keep_base=True)}
    values = mc.compute()
    stats = mc._epoch_sync.stats
    assert (stats.packed_syncs, stats.sync_collectives, stats.eager_fallbacks) == (1, 0, 0)
    for name, m in mc.items(keep_base=True):
        assert m._epoch is None, f"{name} synced itself"
        assert not m._is_synced and torch.equal(m.tp, local[name])
    alone = member()
    rng = np.random.default_rng(9)
    for _ in range(3):
        alone.update(torch.from_numpy(rng.standard_normal((16, 5)).astype(np.float32)), torch.from_numpy(rng.integers(0, 5, 16)))
    assert torch.equal(values["a"], alone.compute())


_COLLECTION_TWO_RANKS = """
import sys
import numpy as np
import torch
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

def members():
    return {
        "acc": MulticlassAccuracy(num_classes=4, device="cpu"),
        "acc_w": MulticlassAccuracy(num_classes=4, average="weighted", device="cpu"),
        "auroc": MulticlassAUROC(num_classes=4, thresholds=9, device="cpu"),
        "auroc_exact": MulticlassAUROC(num_classes=4, device="cpu"),
        "cm": MulticlassConfusionMatrix(num_classes=4, device="cpu"),
        "cm_t": MulticlassConfusionMatrix(num_classes=4, normalize="true", device="cpu"),
    }

def batches(rank):
    rng = np.random.default_rng(100 + rank)
    out = []
    for _ in range(3 + 2 * rank):  # rank 0: 3 batches, rank 1: 5 (ragged cat lists)
        p = rng.random((12, 4)).astype(np.float32)
        out.append((torch.from_numpy(p / p.sum(1, keepdims=True)), torch.from_numpy(rng.integers(0, 4, 12))))
    return out

def run(rank):
    mc = MetricCollection(members())
    for p, t in batches(rank):
        mc.update(p, t)
    mc.persistent(True)
    local = mc.state_dict()
    owners = [(g.owner, mc._modules[g.owner]) for g in mc._groups.values()]
    plan = PackedSyncPlan(owners, 2)
    meta = plan.metadata_local()
    plan.finalize(None if meta is None else np.stack([meta, meta]))
    values = mc.compute()
    after = mc.state_dict()
    stats = mc._epoch_sync.stats
    torch.save({"local": local, "after": after, "values": values}, f"{sys.argv[1]}/rank{rank}.pt")
    return {
        "packed_syncs": stats.packed_syncs,
        "sync_collectives": stats.sync_collectives,
        "fallbacks": stats.eager_fallbacks + sum(m._epoch.stats.eager_fallbacks for m in mc.values() if m._epoch),
        "member_syncs": sum(1 for m in mc.values() if m._epoch is not None),
        "buffer_keys": plan.buffer_keys(),
        "rank_invariant": plan.rank_invariant,
        "groups": list(mc.compute_groups.values()),
    }
"""


def test_collection_compute_over_two_gloo_ranks(tmp_path):
    from torchmetrics_tpu_torch.classification import MulticlassAUROC, MulticlassConfusionMatrix

    results = run_two_ranks(tmp_path, _COLLECTION_TWO_RANKS)
    for rank, res in enumerate(results):
        assert res["ok"], res
        assert res["groups"] == [["acc", "acc_w"], ["auroc"], ["auroc_exact"], ["cm", "cm_t"]]
        assert res["packed_syncs"] == 1 and res["fallbacks"] == 0 and res["member_syncs"] == 0, res
        assert res["buffer_keys"] == ["gather:float32", "gather:int64", "reduce:int32"]
        assert res["rank_invariant"] is False
        assert res["sync_collectives"] == len(res["buffer_keys"]) + 1, res  # + the metadata gather
    saved = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    def member(name):
        return {
            "acc": lambda: MulticlassAccuracy(num_classes=4, device="cpu"),
            "acc_w": lambda: MulticlassAccuracy(num_classes=4, average="weighted", device="cpu"),
            "auroc": lambda: MulticlassAUROC(num_classes=4, thresholds=9, device="cpu"),
            "auroc_exact": lambda: MulticlassAUROC(num_classes=4, device="cpu"),
            "cm": lambda: MulticlassConfusionMatrix(num_classes=4, device="cpu"),
            "cm_t": lambda: MulticlassConfusionMatrix(num_classes=4, normalize="true", device="cpu"),
        }[name]()

    for name in saved[0]["values"]:
        folded, other = member(name), member(name)
        folded.load_state_dict(saved[0]["local"], prefix=f"{name}.")
        other.load_state_dict(saved[1]["local"], prefix=f"{name}.")
        folded.merge_state(other)
        want = folded.compute()
        for rank in range(2):
            got = saved[rank]["values"][name]
            if want.dtype == torch.int32:
                assert torch.equal(got, want), (rank, name)
            else:
                torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # each rank's local state is back after compute
    for rank in range(2):
        for key, value in saved[rank]["local"].items():
            after = saved[rank]["after"][key]
            if isinstance(value, list):
                assert all(torch.equal(a, b) for a, b in zip(value, after)) and len(value) == len(after), key
            elif isinstance(value, torch.Tensor):
                assert torch.equal(value, after), key
