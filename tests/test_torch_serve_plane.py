"""The port's serving plane against the JAX package on the CPU: the SLO registry and
its evaluator, the exposition families, the sidecar's endpoints, the federation
envelopes and folds, the fleet merge, and the packed plan's heavy-hitter fold.

Pods are emulated in one process: each package's metrics updated on the same
numpy-seeded batches, their envelopes handed to the aggregators directly.
"""

from __future__ import annotations

import random
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.serve as js
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.serve as ts
from torchmetrics_tpu.diag import hist as jhist
from torchmetrics_tpu.diag import slo as jslo
from torchmetrics_tpu.diag import telemetry as jtel
from torchmetrics_tpu.parallel.packing import PackedSyncPlan as JaxPlan
from torchmetrics_tpu.serve import federation as jfed
from torchmetrics_tpu.serve import fleet as jfleet
from torchmetrics_tpu_torch.diag import hist as thist
from torchmetrics_tpu_torch.diag import slo as tslo
from torchmetrics_tpu_torch.diag import telemetry as ttel
from torchmetrics_tpu_torch.engine.stats import reset_engine_stats
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan, PackingError
from torchmetrics_tpu_torch.serve import federation as tfed
from torchmetrics_tpu_torch.serve import fleet as tfleet
from torchmetrics_tpu_torch.serve.sketch import merge_topk


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal_tree(got, want, msg: str = "", atol: float = 0.0) -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), f"{msg}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            _equal_tree(got[k], want[k], f"{msg}[{k}]", atol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_tree(g, w, f"{msg}[{i}]", atol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, f"{msg}: {g.shape} vs {w.shape}"
    if atol and g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=msg)
    else:
        np.testing.assert_array_equal(g, w, err_msg=msg)


@pytest.fixture(autouse=True)
def _clean_stats():
    from torchmetrics_tpu.engine.stats import reset_engine_stats as jax_reset

    reset_engine_stats()
    jax_reset()
    yield
    reset_engine_stats()
    jax_reset()


# ---------------------------------------------------------------- the SLO engine


def test_slo_registry_is_the_jax_one():
    assert tslo.SLO_REGISTRY == jslo.SLO_REGISTRY
    assert tslo.DEFAULT_SLOW_WINDOW_S == jslo.DEFAULT_SLOW_WINDOW_S
    assert [s.__dict__ for s in tslo._specs()] == [s.__dict__ for s in jslo._specs()]


def _slo_inputs(hist_mod, counters: dict, latencies: list) -> dict:
    h = hist_mod.Histogram()
    for v in latencies:
        h.record(v)
    return {"counters": dict(counters), "series": lambda name: h if name == "sync_us" else hist_mod.Histogram()}


# (now, counters, sync latencies so far): a breach that needs both windows, a
# recovery on the fast one, a quantile tail, an idle ratio window
_SLO_SCRIPT = [
    (0.0, {}, [100.0] * 20),
    (1.0, {"sync_degraded_folds": 1, "dispatches": 10}, [100.0] * 20 + [9000.0] * 50),
    (5.0, {"sync_degraded_folds": 1, "dispatches": 1000, "quarantined_batches": 6}, [100.0] * 20 + [9000.0] * 50),
    (16.0, {"sync_degraded_folds": 1, "dispatches": 1000, "quarantined_batches": 6}, [100.0] * 90 + [9000.0] * 50),
    (40.0, {"sync_degraded_folds": 2, "dispatches": 1200, "quarantined_batches": 6, "fleet_degraded_pulls": 1}, [100.0] * 400),
]


@pytest.mark.parametrize("slow_s, fast_s", [(100.0, 10.0), (30.0, 3.0)])
def test_slo_engine_rows(slow_s, fast_s):
    """The same observations at the same ``now`` values give the same rows, blocking
    breaches and transition counts."""
    port, ref = tslo.SLOEngine("p"), jslo.SLOEngine("j")
    with tslo.slo_context(slow_s, fast_s), jslo.slo_context(slow_s, fast_s):
        for now, counters, lat in _SLO_SCRIPT:
            got = port.evaluate(_slo_inputs(thist, counters, lat), now=now)
            want = ref.evaluate(_slo_inputs(jhist, counters, lat), now=now)
            assert got == want, now
            assert port.blocking_breaches() == ref.blocking_breaches()
        assert port.state() == ref.state()
    assert (port.stats.slo_breaches, port.stats.slo_recoveries) == (ref.stats.slo_breaches, ref.stats.slo_recoveries)
    assert port.stats.slo_evaluations == len(_SLO_SCRIPT)


# ---------------------------------------------------------------- exposition


def _families(text: str, prefixes) -> set:
    return {line.split(" ")[2] for line in text.splitlines() if line.startswith("# TYPE ") and line.split(" ")[2].startswith(prefixes)}


def _serving_objects(pkg_agg, pkg_serve, device_kw: dict):
    tenancy = pkg_serve.TenantSlices(pkg_agg.SumMetric(nan_strategy=0.0, **device_kw), capacity=4)
    kll = pkg_serve.KLLSketch(k=8, levels=6, **device_kw)
    return tenancy, kll


def test_exposition_families_match():
    """The serve, federation, fleet and SLO families a scrape renders have the JAX
    names."""
    objs = []
    import torchmetrics_tpu.aggregation as ja
    import torchmetrics_tpu_torch.aggregation as ta

    for pkg_agg, pkg_serve, kw, to in ((ta, ts, {"device": "cpu"}, torch.from_numpy), (ja, js, {}, jnp.asarray)):
        tenancy, kll = _serving_objects(pkg_agg, pkg_serve, kw)
        tenancy.update(to(np.asarray(5)), to(np.ones(3, dtype=np.float32)))
        kll.update(to(np.arange(20, dtype=np.float32)))
        objs.append((tenancy, kll))
    agg_t = ts.FederationAggregator({"kll": ts.KLLSketch(k=8, levels=6, device="cpu")})
    agg_j = js.FederationAggregator({"kll": js.KLLSketch(k=8, levels=6)})
    agg_t.ingest("p0", *ts.pack_envelope({"kll": objs[0][1]}))
    agg_j.ingest("p0", *js.pack_envelope({"kll": objs[1][1]}))
    agg_t.fold()
    agg_j.fold()
    fleet_t = ts.FleetTelemetry({"p0": lambda: ts.pack_telemetry()})
    fleet_j = js.FleetTelemetry({"p0": lambda: js.pack_telemetry()})
    fleet_t.pull_round()
    fleet_j.pull_round()
    tslo.evaluate_slos()
    jslo.evaluate_slos()
    prefixes = ("tm_tpu_serve", "tm_tpu_federation", "tm_tpu_fleet", "tm_tpu_slo")
    assert _families(ttel.export_prometheus(), prefixes) == _families(jtel.export_prometheus(), prefixes)
    assert _families(fleet_t.export_prometheus(), ("tm_tpu_",)) == _families(fleet_j.export_prometheus(), ("tm_tpu_",))
    for family in _families(ttel.export_prometheus(), ("tm_tpu_",)):
        base = family.removesuffix("_total")
        assert base.endswith(ttel.UNIT_SUFFIXES) or base in ttel.UNITLESS_COUNT_FAMILIES, family
    snap_t, snap_j = ttel.telemetry_snapshot(), jtel.telemetry_snapshot()
    assert set(snap_t) == set(snap_j) and set(snap_t["persist"]) == set(snap_j["persist"])
    persist = ("tm_tpu_persist", "tm_tpu_prewarm")
    assert _families(ttel.export_prometheus(), persist) == _families(jtel.export_prometheus(), persist)
    assert len(_families(ttel.export_prometheus(), ("tm_tpu_persist_",))) == 9  # seven of the store and two of the lookups
    assert set(ttel._build_info_labels()) == {"version", "torch", "cuda", "backend", "device_kind", "device_count", "mesh"}


# ---------------------------------------------------------------- the sidecar

_PATHS = ("/metrics", "/telemetry", "/healthz", "/slo", "/state", "/telemetry.bin", "/fleet/metrics", "/fleet/slo", "/nope")


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=20) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


@pytest.mark.parametrize("with_targets", [False, True])
def test_sidecar_endpoints_match_jax(with_targets):
    """Every endpoint answers on 127.0.0.1 with the JAX sidecar's status and content
    type, with and without a state target and a fleet target."""
    port_m = tc.MulticlassAccuracy(3, device="cpu")
    ref_m = jc.MulticlassAccuracy(3)
    port_m.update(torch.eye(3), torch.arange(3))
    ref_m.update(jnp.eye(3), jnp.arange(3))
    answers = {}
    for name, sidecar_cls, metric, fleet_cls, pack in (
        ("port", ts.MetricsSidecar, port_m, ts.FleetTelemetry, ts.pack_telemetry),
        ("jax", js.MetricsSidecar, ref_m, js.FleetTelemetry, js.pack_telemetry),
    ):
        kw = {"state_target": {"acc": metric}, "fleet_target": fleet_cls({"p0": lambda pack=pack: pack()})} if with_targets else {}
        if with_targets:
            kw["fleet_target"].pull_round()
        with sidecar_cls(port=0, **kw) as sc:
            answers[name] = {path: _get(sc.port, path) for path in _PATHS}
    for path in _PATHS:
        got, want = answers["port"][path], answers["jax"][path]
        assert got[:2] == want[:2], (path, got[:2], want[:2])
    if with_targets:
        env = tfed.parse_envelope(answers["port"]["/state"][2])
        _equal_tree(env.states["acc"], {k: _np(getattr(port_m, k)) for k in port_m._defaults})


# ---------------------------------------------------------------- federation


def _pod_metrics(pkg_cls, pkg_serve, kw: dict):
    return {
        "acc": pkg_cls.MulticlassAccuracy(5, validate_args=False, **kw),
        "auroc": pkg_cls.MulticlassAUROC(5, thresholds=20, validate_args=False, **kw),
        "hll": pkg_serve.CardinalitySketch(p=6, **kw),
        "hh": pkg_serve.HeavyHitters(k=4, depth=2, width=32, **kw),
        "kll": pkg_serve.KLLSketch(k=8, levels=6, **kw),
    }


def _pod_batches(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        scores = rng.dirichlet(np.ones(5), 16).astype(np.float32)
        out.append((scores, rng.integers(0, 5, 16), rng.integers(0, 60, 40), rng.lognormal(size=30).astype(np.float32)))
    return out


def _drive(metrics: dict, batches, to) -> dict:
    for scores, target, ids, lat in batches:
        metrics["acc"].update(to(scores), to(target))
        metrics["auroc"].update(to(scores), to(target))
        metrics["hll"].update(to(ids))
        metrics["hh"].update(to(ids))
        metrics["kll"].update(to(lat))
    return metrics


def _pods(n: int = 4):
    port = {f"pod{i}": _drive(_pod_metrics(tc, ts, {"device": "cpu"}), _pod_batches(i), torch.from_numpy) for i in range(n)}
    ref = {f"pod{i}": _drive(_pod_metrics(jc, js, {}), _pod_batches(i), jnp.asarray) for i in range(n)}
    return port, ref


def _aggregate(agg_cls, pack, pods: dict, order, staleness_s=None):
    agg = agg_cls(_pod_metrics(tc, ts, {"device": "cpu"}) if agg_cls is ts.FederationAggregator else _pod_metrics(jc, js, {}),
                  staleness_s=staleness_s)
    for pid in order:
        assert agg.ingest(pid, *pack(pods[pid]))
    return agg


def test_envelopes_cross_parse():
    """A port envelope parses in the JAX package and a JAX envelope in the port's, with
    equal states. The kept dtype difference: the JAX package's 64-bit mode widens some
    stat counts (``fp``, ``fn``, ``tn``, the binned confusion tensor) to int64 where
    the port keeps int32."""
    port, ref = _pods(1)
    pe_bytes, pe_headers = ts.pack_envelope(port["pod0"])
    je_bytes, je_headers = js.pack_envelope(ref["pod0"])
    from_port = jfed.parse_envelope(pe_bytes, pe_headers)
    from_jax = tfed.parse_envelope(je_bytes, je_headers)
    assert from_port.seq == from_jax.seq == 15 and from_port.update_counts == from_jax.update_counts
    _equal_tree(from_port.states, from_jax.states, "states")
    assert from_port.states["acc"]["fp"].dtype == from_port.states["auroc"]["confmat"].dtype == np.int32
    assert from_jax.states["acc"]["fp"].dtype == from_jax.states["auroc"]["confmat"].dtype == np.int64
    assert pe_headers.keys() == je_headers.keys()


def test_federation_fold_matches_jax_and_is_order_stable():
    port, ref = _pods(4)
    order = sorted(port)
    random.Random(7).shuffle(order)
    agg_t = _aggregate(ts.FederationAggregator, ts.pack_envelope, port, order)
    agg_j = _aggregate(js.FederationAggregator, js.pack_envelope, ref, order)
    fold_t, fold_j = agg_t.fold(), agg_j.fold()
    _equal_tree(fold_t, fold_j, "fold")
    _equal_tree(agg_t.compute_global(), agg_j.compute_global(), "global", atol=1e-6)
    # another arrival order: byte-equal fold
    again = _aggregate(ts.FederationAggregator, ts.pack_envelope, port, sorted(port, reverse=True)).fold()
    for owner, states in fold_t.items():
        for attr, v in states.items():
            assert _np(v).tobytes() == _np(again[owner][attr]).tobytes(), (owner, attr)
    # the grid and the joint top-k equal a single pass over the union stream
    union = ts.HeavyHitters(k=4, depth=2, width=32, device="cpu")
    for i in range(4):
        for _, _, ids, _ in _pod_batches(i):
            union.update(torch.from_numpy(ids))
    assert torch.equal(fold_t["hh"]["cms"], union.cms)
    assert agg_t.stats.federation_folds == 2 and agg_t.stats.federation_ingests == 4


def test_federation_degraded_fold_matches_jax():
    port, ref = _pods(4)
    aggs = []
    for agg_cls, pack, pods in ((ts.FederationAggregator, ts.pack_envelope, port), (js.FederationAggregator, js.pack_envelope, ref)):
        agg = _aggregate(agg_cls, pack, pods, sorted(pods), staleness_s=100.0)
        agg._slots["pod2"].ts -= 1000.0  # pod2's snapshot is past the staleness bound
        aggs.append(agg)
    fold_t, fold_j = aggs[0].fold(), aggs[1].fold()
    _equal_tree(fold_t, fold_j, "degraded fold")
    assert aggs[0].last_coverage == aggs[1].last_coverage
    assert aggs[0].stats.federation_degraded_folds == aggs[1].stats.federation_degraded_folds == 1
    assert aggs[0].federation_state() == aggs[1].federation_state() == {"pods": 3, "degraded_pods": 1}


# ---------------------------------------------------------------- the fleet


def _telemetry(hist_mod, counter_fields, seq: int, lat: list, counters: dict, flags: int) -> dict:
    h = hist_mod.Histogram()
    for v in lat:
        h.record(v)
    row = {f: 0 for f in counter_fields}
    row.update(counters)
    return {
        "counters": row,
        "reasons": {"fallback_reasons": {"list-state": seq}, "retrace_causes": {}, "scan_flush_reasons": {}},
        "sentinels": [{"owner": "acc", "flags": flags}],
        "ledger_totals": {"executables": 2.0, "peak_bytes_max": 100.0 * seq},
        "hists": {("collection", "sync", "sync_us"): h},
        "seq": seq,
        "uptime_s": 3.0,
    }


def test_fleet_merge_matches_jax():
    from torchmetrics_tpu.engine.stats import _COUNTER_FIELDS as jfields
    from torchmetrics_tpu_torch.engine.stats import _COUNTER_FIELDS as tfields

    pods = {"a": (1, [100.0, 200.0], {"dispatches": 5}, 1), "b": (4, [9000.0] * 3, {"dispatches": 7, "eager_fallbacks": 2}, 4)}
    merged = []
    for fleet_mod, hist_mod, fields in ((tfleet, thist, tfields), (jfleet, jhist, jfields)):
        fleet = fleet_mod.FleetTelemetry(
            {pid: (lambda args=args: fleet_mod.pack_telemetry(_telemetry(hist_mod, fields, *args))) for pid, args in pods.items()}
        )
        assert fleet.pull_round() == {"a": True, "b": True}
        merged.append(fleet.merge())
    got, want = merged
    common = set(tfields) & set(jfields)
    assert {k: got["counters"][k] for k in common} == {k: want["counters"][k] for k in common}
    for key in ("members", "degraded", "reasons", "sentinels", "ledger_totals"):
        assert got[key] == want[key], key
    assert got["histograms"]["sync_us"].counts == want["histograms"]["sync_us"].counts


def test_fleet_degraded_pull_flips_the_blocking_slo():
    """A planted degraded pull flips the fleet's blocking row, in both packages."""
    from torchmetrics_tpu.parallel.faults import RankDrop as JaxRankDrop
    from torchmetrics_tpu.parallel.faults import fault_context as jax_fault_context
    from torchmetrics_tpu_torch.parallel.faults import RankDrop, fault_context

    rows = []
    for fleet_mod, slo_mod, drop, ctx in ((tfleet, tslo, RankDrop, fault_context), (jfleet, jslo, JaxRankDrop, jax_fault_context)):
        seqs = {"p0": 1, "p1": 1}
        fleet = fleet_mod.FleetTelemetry({pid: (lambda pid=pid: fleet_mod.pack_telemetry(seq=seqs[pid])) for pid in seqs})
        with slo_mod.slo_context(100.0, 10.0):
            fleet.pull_round()
            fleet.evaluate_slos(now=0.0)
            seqs["p0"] = 2
            with ctx(drop(1, label="fleet-pull*")):
                assert fleet.pull_round() == {"p0": True, "p1": False}
            row = next(r for r in fleet.evaluate_slos(now=1.0) if r["id"] == "fleet-degraded-pulls")
        assert row["breaching"] and row["blocking"] and fleet.slo.blocking_breaches() == ["fleet-degraded-pulls"]
        rows.append({k: row[k] for k in ("id", "breaching", "blocking", "measured")})
    assert rows[0] == rows[1]


# ---------------------------------------------------------------- the packed plan


def _two_hh(pkg_serve, kw, to):
    a, b = pkg_serve.HeavyHitters(k=6, depth=3, width=64, **kw), pkg_serve.HeavyHitters(k=6, depth=3, width=64, **kw)
    a.update(to(np.concatenate([np.full(300, 7), np.arange(60)])))
    b.update(to(np.concatenate([np.full(200, 13), np.full(120, 7), np.arange(40, 110)])))
    return a, b


def test_packed_hh_fold_matches_jax_plan():
    """Two emulated ranks through the packed plan: the grid sums and the (ids, counts)
    pair folds jointly against it, as the JAX plan folds; ``metadata_from_state`` and
    ``pack_from`` over the ranks' snapshots give the same buffers and fold."""
    ta_, tb_ = _two_hh(ts, {"device": "cpu"}, torch.from_numpy)
    ja_, jb_ = _two_hh(js, {}, jnp.asarray)
    tplan = [PackedSyncPlan([("m", m)], world_size=2) for m in (ta_, tb_)]
    jplan = [JaxPlan([("m", m)], world_size=2) for m in (ja_, jb_)]
    for p in tplan + jplan:
        assert p.metadata_local() is None
        p.finalize(None)
    tp, jp = [p.pack() for p in tplan], [p.pack() for p in jplan]
    assert sorted(tp[0]) == sorted(jp[0]) == ["gather:int64", "reduce:int64"]
    t_fold = tplan[0].make_fold()({k: torch.stack([tp[0][k], tp[1][k]]) for k in tp[0]})["m"]
    j_fold = jplan[0].make_fold()({k: jnp.stack([jp[0][k], jp[1][k]]) for k in jp[0]})["m"]
    _equal_tree(t_fold, j_fold, "hh fold")
    ids, counts = merge_topk(t_fold["cms"], torch.cat([ta_.hh_ids, tb_.hh_ids]), 6, 3, 64)
    assert torch.equal(t_fold["hh_ids"], ids) and torch.equal(t_fold["hh_counts"], counts)
    snaps = [{"m": {k: _np(getattr(m, k)) for k in m._defaults}} for m in (ta_, tb_)]
    jsnaps = [{"m": {k: np.asarray(getattr(m, k)) for k in m._defaults}} for m in (ja_, jb_)]
    np.testing.assert_array_equal(tplan[0].metadata_from_state(snaps[0]) is None, jplan[0].metadata_from_state(jsnaps[0]) is None)
    packed = [tplan[0].pack_from(s) for s in snaps]
    jpacked = [jplan[0].pack_from(s) for s in jsnaps]
    for k in packed[0]:
        _equal_tree(packed[0][k], jpacked[0][k], k)
    again = tplan[0].make_fold()({k: torch.stack([packed[0][k], packed[1][k]]) for k in packed[0]})["m"]
    _equal_tree(again, t_fold, "pack_from fold")


def test_packed_hh_layout_is_checked():
    """A pair registered out of order cannot ride the plan (the fold needs the merged
    grid first)."""
    from torchmetrics_tpu_torch.metric import Metric

    class Misordered(Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("ids", torch.full((2,), -1), dist_reduce_fx=lambda x: x[0], spec={"role": "hh-ids", "hh": ("grid", 2, 1, 4)})
            self.add_state("counts", torch.zeros(2), dist_reduce_fx=lambda x: x[0], spec={"role": "hh-counts"})
            self.add_state("grid", torch.zeros((1, 4)), dist_reduce_fx="sum", spec={"role": "hh-grid"})

        def update(self, x):
            pass

        def compute(self):
            return self.grid

    with pytest.raises(PackingError, match="grid registered before"):
        PackedSyncPlan([("m", Misordered())], world_size=2)
    with pytest.raises(ValueError, match="unknown role"):
        Misordered().add_state("x", torch.zeros(1), spec={"role": "hh-id"})


@pytest.mark.parametrize("metadata", ["cat", "shape"])
def test_metadata_from_state_matches_metadata_local(metadata):
    """The snapshot probe is the live probe's, entry for entry."""
    from torchmetrics_tpu_torch.aggregation import CatMetric

    if metadata == "cat":
        m = CatMetric(nan_strategy=0.0, device="cpu")
        m.update(torch.arange(5.0))
        m.update(torch.arange(3.0))
    else:
        m = tc.MulticlassAccuracy(3, device="cpu")
        m.update(torch.eye(3), torch.arange(3))
    plan = PackedSyncPlan([("m", m)], world_size=2)
    snap = {"m": {k: getattr(m, k) for k in m._defaults}}
    live = plan.metadata_local()
    from_state = plan.metadata_from_state(snap)
    assert (live is None and from_state is None) or np.array_equal(live, from_state)
