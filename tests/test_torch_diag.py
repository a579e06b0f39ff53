"""The port's diagnostics plane (``torchmetrics_tpu_torch/diag/``) against the JAX package's.

Comparisons are exact unless stated: histogram buckets, quantiles and merges on the same
sample streams; ``resolve_arrivals`` and ``merge_timelines`` on the same stamps and event
dicts (byte-identical JSON); the divergence audit's fingerprints of the same states; the
lineage watermarks after the same scan sequence; ``diag_report``'s keys; the transfer
guard's labels. The engines' events are held to the JAX ``EVENT_KINDS``, the guard is
driven through its Python layer (the native layer needs a card), and two gloo ranks on
the CPU run the cross-rank pieces: the straggler, the in-flight deadline that degrades
onto it, the OR-folded sentinel, the audit and the layout-version check.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.diag import hist as jhist
from torchmetrics_tpu.diag import lineage as jlin
from torchmetrics_tpu.diag import timeline as jtl
from torchmetrics_tpu.diag.trace import EVENT_KINDS as JAX_EVENT_KINDS
from torchmetrics_tpu.diag.transfer_guard import TRANSFER_LABEL_PREFIXES as JAX_PREFIXES
from torchmetrics_tpu.diag.transfer_guard import TRANSFER_LABELS as JAX_LABELS
from torchmetrics_tpu_torch import diag as tdiag
from torchmetrics_tpu_torch.diag import hist as thist
from torchmetrics_tpu_torch.diag import lineage as tlin
from torchmetrics_tpu_torch.diag import timeline as ttl
from torchmetrics_tpu_torch.engine import engine_context as t_engine

# the package exports the ``transfer_guard`` function under the module's name
tguard = importlib.import_module("torchmetrics_tpu_torch.diag.transfer_guard")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 90


# ---------------------------------------------------------------- histograms


def _streams(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [
        rng.lognormal(3.0, 1.5, 700).tolist(),  # latencies, µs
        rng.integers(0, 2**31, 200).astype(float).tolist(),  # sizes up to past the top bound
        [0.0, 0.1, 0.25, 0.26, 2.0**30, 2.0**31, float("nan")],  # the edges and a NaN
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_equal_jax(seed):
    hists = []
    for mod in (jhist, thist):
        row = []
        for stream in _streams(seed):
            h = mod.Histogram()
            for v in stream:
                h.record(v)
            row.append(h)
        hists.append(row)
    for j, t in zip(*hists):
        assert t.counts == j.counts and t.total == j.total and t.min == j.min and t.max == j.max
        assert [t.quantile(q) for q in (0.5, 0.9, 0.99)] == [j.quantile(q) for q in (0.5, 0.9, 0.99)]
        assert thist.hist_to_arrays(t)[0] == jhist.hist_to_arrays(j)[0]
        np.testing.assert_array_equal(thist.hist_to_arrays(t)[1], jhist.hist_to_arrays(j)[1])
        back = thist.hist_from_arrays(*jhist.hist_to_arrays(j))
        assert back.counts == j.counts and back.as_dict() == j.as_dict()
    tm, jm = thist.merge_hists(*hists[1][:2]), jhist.merge_hists(*hists[0][:2])
    assert tm.as_dict() == jm.as_dict() and tm.counts == jm.counts
    assert thist.BOUNDS == jhist.BOUNDS and thist.GROWTH == jhist.GROWTH and len(thist.BOUNDS) + 1 == 130


def test_histogram_registry_resets_with_engine_stats():
    from torchmetrics_tpu_torch.engine import reset_engine_stats

    thist.observe("o", "k", "dispatch_us", 3.0)
    assert [r["series"] for r in thist.histograms_snapshot() if r["owner"] == "o"] == ["dispatch_us"]
    reset_engine_stats()
    assert thist.histograms_snapshot() == []


# ---------------------------------------------------------------- timeline


@pytest.mark.parametrize(
    "prev_post, arrivals, local",
    [
        ([1000, 1500], [2000, 2500], 0),
        ([0, 1500], [2000, 2600], 1),
        ([0x7FFFFF00, 40], [0x7FFFFFF0, 300], 0),  # rank 1's clock wrapped
        ([500, 400, 900], [7000, 9000, 7500], 2),
    ],
)
def test_resolve_arrivals_equals_jax(prev_post, arrivals, local):
    assert ttl.resolve_arrivals(prev_post, arrivals, local) == jtl.resolve_arrivals(prev_post, arrivals, local)


def test_merge_timelines_is_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    kinds = ["update.dispatch", "collective", "sync.exchange", "compute.dispatch", "lineage.observe", "fallback"]
    streams = []
    for rank in range(2):
        events = []
        for i in range(40):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            ev = {"seq": i + 1, "ts_us": float(rng.uniform(0, 1e6)), "kind": kind, "owner": "Acc" if i % 3 else ""}
            if kind in ("update.dispatch", "sync.exchange", "compute.dispatch"):
                ev["dispatch_us"] = float(rng.uniform(1, 500))
            if kind == "collective":
                ev["label"] = "reduce:int32"
                ev["bytes"] = int(rng.integers(1, 1 << 20))
            if i % 7 == 0:
                ev["lineage"] = int(rng.integers(1, 5))
            events.append(ev)
        streams.append({"rank": rank, "events": events, "clock_offset_us": float(rank * 250)})
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    ttl.merge_timelines(streams, path=str(got))
    jtl.merge_timelines(streams, path=str(want))
    assert got.read_bytes() == want.read_bytes()
    fleet = [dict(s, pod=f"p{i}") for i, s in enumerate(streams)]
    assert json.dumps(ttl.merge_timelines(fleet), sort_keys=True) == json.dumps(jtl.merge_timelines(fleet), sort_keys=True)


# ---------------------------------------------------------------- audit fingerprints


def _audit_entries(plan_cls, metric, audit_ctx) -> np.ndarray:
    with audit_ctx(True):
        return np.asarray(plan_cls([("", metric)], 2, None).metadata_local())


@pytest.mark.parametrize("seed", [0, 3])
def test_audit_fingerprints_equal_jax(seed):
    """The same int32 and float32 states give the same (crc32, count) pairs."""
    from torchmetrics_tpu import classification as jclf
    from torchmetrics_tpu.diag.sentinel import audit_context as jaudit
    from torchmetrics_tpu.parallel.packing import PackedSyncPlan as JPlan
    from torchmetrics_tpu_torch.diag.sentinel import audit_context as taudit
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan as TPlan

    rng = np.random.default_rng(seed)
    preds = rng.integers(0, 5, 64)
    target = rng.integers(0, 5, 64)
    jstat = jclf.MulticlassStatScores(5, average=None)
    tstat = ttm.MulticlassStatScores(5, average=None, device="cpu")
    jstat.update(jnp.asarray(preds), jnp.asarray(target))
    tstat.update(torch.from_numpy(preds), torch.from_numpy(target))
    # float32 states holding the same values (a reduction's order would differ), NaN included
    jmean, tmean = jtm.MeanMetric(), ttm.MeanMetric(device="cpu")
    for attr, value in (("value", np.float32(rng.normal())), ("weight", np.float32(np.nan if seed else 7.5))):
        setattr(jmean, attr, jnp.asarray(value))
        setattr(tmean, attr, torch.tensor(value))
    for jm, tm in ((jstat, tstat), (jmean, tmean)):
        np.testing.assert_array_equal(_audit_entries(TPlan, tm, taudit), _audit_entries(JPlan, jm, jaudit))


def test_audit_flags_a_divergent_rank_invariant_state_and_duplicate_sums():
    from torchmetrics_tpu_torch.diag.sentinel import audit_context
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

    m = ttm.MeanMetric(device="cpu")
    m.update(torch.ones(4))
    with audit_context(True):
        plan = PackedSyncPlan([("", m)], 2)
        meta = plan.metadata_local()
        plan.finalize(np.stack([meta, meta]))
    assert {r["attr"]: r["flag"] for r in plan.audit_results} == {"value": "duplicate-suspect", "weight": "duplicate-suspect"}
    m._rank_invariant_states = frozenset({"weight"})
    with audit_context(True):
        plan = PackedSyncPlan([("", m)], 2)
        meta = plan.metadata_local()
        other = meta.copy()
        other[-1] ^= 0x5A  # rank 1's weight has another element count
        plan.finalize(np.stack([meta, other]))
    assert {r["attr"]: r["flag"] for r in plan.audit_results}["weight"] == "rank-invariant-divergence"
    with audit_context(False):
        assert PackedSyncPlan([("", m)], 2).metadata_local() is None  # no audit: no gather


def test_timeline_forces_the_metadata_gather_and_checks_the_version():
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    m = ttm.SumMetric(device="cpu")
    m.update(torch.ones(3))
    assert PackedSyncPlan([("", m)], 2).metadata_local() is None  # rank-invariant
    with tdiag.profile_context(every_n=4):
        plan = PackedSyncPlan([("", m)], 2)
        meta = plan.metadata_local()
        assert meta is not None and meta[-3] == ttl.LAYOUT_VERSION
        bad = meta.copy()
        bad[-3] = 99
        with pytest.raises(TorchMetricsUserError, match="timeline layout"):
            plan.finalize(np.stack([meta, bad]))


# ---------------------------------------------------------------- lineage


def _lineage_run(jax_side: bool) -> dict:
    """Scan K = 4 with quarantine: 6 updates (the third poisoned), compute, 3 updates, a
    reset (which discards them), 2 updates, compute."""
    lin = jlin if jax_side else tlin
    lin.reset_lineage()
    if jax_side:
        from torchmetrics_tpu.engine import engine_context, scan, txn

        make = lambda: jtm.SumMetric(nan_strategy=0.0)  # noqa: E731
        to = jnp.asarray
    else:
        from torchmetrics_tpu_torch.engine import engine_context, scan, txn

        make = lambda: ttm.SumMetric(nan_strategy=0.0, device="cpu")  # noqa: E731
        to = torch.from_numpy
    rng = np.random.default_rng(11)
    batches = [rng.normal(size=(16,)).astype(np.float32) for _ in range(11)]
    batches[2][5] = np.nan
    with engine_context(True), scan.scan_context(4), txn.quarantine_context(True):
        m = make()
        for x in batches[:6]:
            m.update(to(x))
        m.compute()
        for x in batches[6:9]:
            m.update(to(x))
        m.reset()
        for x in batches[9:]:
            m.update(to(x))
        m.compute()
    row = lin.lineage_snapshot()["owners"]["SumMetric"]
    return {k: row[k] for k in ("steps_enqueued", "steps_folded", "steps_observed", "staleness_steps", "excluded")}


def test_lineage_watermarks_equal_jax():
    got, want = _lineage_run(False), _lineage_run(True)
    assert got == want
    assert got["excluded"] == {"discarded": 3, "quarantined": 1}


def test_lineage_header_and_provenance_api():
    tlin.reset_lineage()
    tlin.note_enqueued("o", 2)
    tlin.note_folded("o", 1)
    rec = tlin.note_observed("o", "compute")
    assert rec.staleness_steps == 1 and tlin.stalest_owner()[0:2] == ("o", 1)
    header = tlin.encode_lineage_header([rec])
    assert tlin.decode_lineage_header(header)[0]["owner"] == "o"
    assert header == jlin.encode_lineage_header([rec.as_dict()])
    assert tlin.LINEAGE_HEADER == jlin.LINEAGE_HEADER
    with pytest.raises(Exception, match="exclusion reason"):
        tlin.note_excluded("o", "bogus", 1)


# ---------------------------------------------------------------- report, ledger, profile


def _observed_run():
    """An engine run with the recorder, the sentinel and a profile on: a metric and a
    fused collection, 8 updates each, then compute."""
    rng = np.random.default_rng(5)
    batches = [(torch.from_numpy(rng.normal(size=(64, 5)).astype(np.float32)), torch.from_numpy(rng.integers(0, 5, 64)))
               for _ in range(8)]
    with t_engine(True), tdiag.sentinel_context(True), tdiag.profile_context(every_n=4), tdiag.diag_context() as rec:
        acc = ttm.MulticlassAccuracy(5, validate_args=False, device="cpu")
        mc = ttm.MetricCollection({
            "acc": ttm.MulticlassAccuracy(5, validate_args=False, device="cpu"),
            "cm": ttm.MulticlassConfusionMatrix(5, validate_args=False, device="cpu"),
        })
        for p, t in batches:
            acc.update(p, t)
            mc.update(p, t)
        acc.compute()
        mc.compute()
        report = tdiag.diag_report(rec)
    return rec, report, acc


def test_report_keys_equal_jax():
    from torchmetrics_tpu.diag import diag_context as jctx
    from torchmetrics_tpu.diag import diag_report as jreport

    tdiag.reset_ledger()
    _, report, _ = _observed_run()
    with jctx() as rec:
        jm = jtm.MeanMetric()
        jm.update(jnp.ones(3))
        jm.compute()
        want = jreport(rec)
    assert list(report) == list(want)
    assert set(report["per_metric"]["MulticlassAccuracy"]) == set(next(iter(want["per_metric"].values())))
    assert set(report["ledger"]) >= set(want["ledger"])


def test_probes_histograms_and_ledger_of_an_observed_run():
    tdiag.reset_ledger()
    from torchmetrics_tpu_torch.diag.profile import reset_profile

    reset_profile()
    rec, report, acc = _observed_run()
    sites = report["profile"]["per_site"]
    # 7 warm updates each: every 4th is a probe
    assert sites["MulticlassAccuracy:update"]["probes"] == 1
    assert sites["fused:MulticlassAccuracy,MulticlassConfusionMatrix:fused"]["probes"] == 1
    series = {(r["owner"], r["kind"], r["series"]) for r in report["histograms"]}
    assert ("MulticlassAccuracy", "update", "dispatch_us") in series
    assert ("MulticlassAccuracy", "update", "device_us") in series
    assert ("MetricCollection", "collection", "dispatch_us") in series
    kinds = {e.kind for e in rec.snapshot()}
    assert {"update.trace", "update.dispatch", "update.probe", "fused.trace", "fused.dispatch", "collection.step",
            "compute.trace", "compute.dispatch", "lineage.observe"} <= kinds
    rows = tdiag.ledger_snapshot()["executables"]
    assert {r["kind"] for r in rows} >= {"update", "fused", "compute"}
    for r in rows:
        assert r["flops"] is None and r["bytes_accessed"] is None and r["analyses_ok"] is False
        assert r["capture_ms"] is None and r["pool_bytes"] is None and r["arg_bytes"] > 0  # the CPU captures nothing
    assert acc._provenance.where == "compute"
    assert tdiag.read_sentinel(acc)["flags"] == 0


def test_event_kinds_are_jax_kinds():
    """Every kind the port records on an observed run with every rider and tier on."""
    from torchmetrics_tpu_torch.engine import async_context, numerics, scan, txn

    rng = np.random.default_rng(9)
    with t_engine(True), tdiag.sentinel_context(True), tdiag.profile_context(every_n=2), tdiag.diag_context() as rec:
        with txn.quarantine_context(True), numerics.compensated_context(True):
            s = ttm.SumMetric(nan_strategy=0.0, device="cpu")
            for i in range(6):
                x = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
                if i == 1:
                    x[0] = float("nan")
                s.update(x)
            s.compute()
            with scan.scan_context(4), async_context(2):
                acc = ttm.MulticlassAccuracy(5, validate_args=False, device="cpu")
                for _ in range(9):
                    acc.update(torch.randn(32, 5), torch.randint(0, 5, (32,)))
                acc.compute()
                acc.update(torch.randn(32, 5), torch.randint(0, 5, (32,)))
                acc.reset()
        eager = ttm.MulticlassAccuracy(5, device="cpu", compiled_update=False)
        eager.update(torch.randn(8, 5), torch.randint(0, 5, (8,)))
    kinds = set(rec.counts)
    assert kinds <= JAX_EVENT_KINDS, kinds - JAX_EVENT_KINDS
    assert {"update.scan", "scan.flush", "async.enqueue", "async.drain", "update.quarantine", "update.eager",
            "numerics.reanchor"} <= kinds, kinds


# ---------------------------------------------------------------- transfer guard


def test_transfer_labels_equal_jax():
    assert tguard.TRANSFER_LABELS == JAX_LABELS and tguard.TRANSFER_LABEL_PREFIXES == JAX_PREFIXES


class _Planted(ttm.SumMetric):
    """A sum whose update reads the host in one of the planted ways."""

    def __init__(self, how: str):
        super().__init__(nan_strategy=0.0, device="cpu")
        self.how = how

    def update(self, x):
        if self.how == "item":
            x.sum().item()
        elif self.how == "tolist":
            x.tolist()
        elif self.how == "asarray":
            np.asarray(x)
        super().update(x)


@pytest.mark.parametrize("how", ["item", "tolist", "asarray"])
@pytest.mark.parametrize("engine", [False, True])
def test_strict_guard_raises_on_a_planted_readback(how, engine):
    with t_engine(engine), tdiag.diag_context() as rec:
        m = _Planted(how)
        with pytest.raises(tdiag.TransferGuardError):
            with tdiag.transfer_guard("strict"):
                m.update(torch.ones(4))
    assert rec.count("transfer.blocked") >= 1
    assert not tguard.hooks_installed()


def test_log_mode_records_and_lets_through():
    with tdiag.diag_context() as rec:
        with tdiag.transfer_guard("log"):
            value = torch.ones(2).sum().item()
    assert value == 2.0 and rec.count("transfer.host") == 1


def test_log_mode_shows_other_warnings_once():
    """A warning that is no readback is shown again when the log scope ends, once."""
    import warnings

    with pytest.warns(UserWarning, match="unrelated") as record:
        with tdiag.transfer_guard("log"):
            warnings.warn("unrelated", UserWarning)
    assert sum("unrelated" in str(w.message) for w in record) == 1


def test_engine_hot_loop_is_clean_under_strict_and_hooks_leave():
    from torchmetrics_tpu_torch.engine import quarantine_context

    originals = {n: torch.Tensor.__dict__.get(n) for n in ("item", "tolist", "numpy", "__array__", "cpu", "to")}
    asarray = np.asarray
    with t_engine(True), tdiag.sentinel_context(True), quarantine_context(True), tdiag.diag_context() as rec:
        mc = ttm.MetricCollection({
            "acc": ttm.MulticlassAccuracy(5, validate_args=False, device="cpu"),
            "cm": ttm.MulticlassConfusionMatrix(5, validate_args=False, device="cpu"),
        })
        mc.update(torch.randn(16, 5), torch.randint(0, 5, (16,)))  # group discovery: sanctioned
        with tdiag.transfer_guard("strict"), tdiag.profile_context(every_n=2):
            for _ in range(6):
                mc.update(torch.randn(16, 5), torch.randint(0, 5, (16,)))
            values = mc.compute()
            flags = [tdiag.read_sentinel(m)["flags"] for m in mc.values()]
    assert rec.count("transfer.host", "transfer.blocked") == 0
    assert flags == [0, 0] and values["cm"].shape == (5, 5)
    assert {n: torch.Tensor.__dict__.get(n) for n in originals} == originals and np.asarray is asarray


def test_nested_guards_and_sanctioned_boundaries():
    with tdiag.transfer_guard("strict"):
        with tdiag.transfer_guard("log"):
            assert tguard.hooks_installed()
        with tdiag.transfer_allowed("sentinel-read"):
            assert torch.ones(1).item() == 1.0
        assert tguard.hooks_installed()
    assert not tguard.hooks_installed()


def test_guard_covers_the_async_worker_through_its_context():
    """The drain worker runs in the submitter's context: a readback it makes is seen."""
    from torchmetrics_tpu_torch.engine import async_context, scan

    m, planted = _Planted("none"), _Planted("item")
    with t_engine(True), tdiag.diag_context() as rec, tdiag.transfer_guard("log"):
        with scan.scan_context(2), async_context(2):
            for _ in range(6):
                m.update(torch.ones(4))
            m.compute()
    assert rec.count("async.drain") >= 1 and rec.count("transfer.host") == 0
    with t_engine(True), tdiag.diag_context() as rec, tdiag.transfer_guard("log"):
        with scan.scan_context(2), async_context(2):
            for _ in range(6):
                planted.update(torch.ones(4))  # the engine demotes the reading update
    assert rec.count("transfer.host") >= 1


# ---------------------------------------------------------------- two gloo ranks

_RUNNER = textwrap.dedent(
    """
    import datetime, json, os, socket, sys, time
    import multiprocessing as mp
    sys.path.insert(0, {root!r})

    {body}

    def _child(rank, port, out):
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{{port}}", world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds={timeout}),
        )
        try:
            res = {{"ok": True, **run(rank)}}
        except Exception as err:
            res = {{"ok": False, "error": type(err).__name__, "message": str(err)}}
        with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
            json.dump(res, f)
        give_up = time.monotonic() + {timeout}
        while time.monotonic() < give_up and not all(
            os.path.exists(os.path.join(out, f"rank{{r}}.json")) for r in range(2)
        ):
            time.sleep(0.05)
        # a collective a deadline escaped may still be pending: leave without tearing
        # the group down (the exit closes its sockets)
        sys.stdout.flush()
        os._exit(0)

    if __name__ == "__main__":
        out = sys.argv[1]
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child, args=(r, port, out)) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + {timeout}
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        print(json.dumps({{"hung": hung}}))
        sys.exit(1 if hung else 0)
    """
)


def _two_ranks(tmp_path, body: str) -> list:
    script = tmp_path / "two_ranks.py"
    script.write_text(_RUNNER.format(root=ROOT, body=textwrap.dedent(body), timeout=JOIN_TIMEOUT_S))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    res = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True, text=True,
                         timeout=JOIN_TIMEOUT_S + 30, env=env)
    assert res.returncode == 0, f"a rank hung or died:\n{res.stdout}\n{res.stderr}"
    out = []
    for rank in range(2):
        path = tmp_path / f"rank{rank}.json"
        assert path.exists(), f"rank {rank} wrote no result:\n{res.stdout}\n{res.stderr}"
        out.append(json.loads(path.read_text()))
    return out


_WORLD_BODY = '''
def run(rank):
    import torch
    import torch.distributed as dist
    from torchmetrics_tpu_torch import MetricCollection, MulticlassAccuracy, MulticlassConfusionMatrix
    from torchmetrics_tpu_torch.diag import (audit_context, diag_context, profile_context, read_sentinel,
                                              sentinel_context, set_straggler_threshold_us)
    from torchmetrics_tpu_torch.engine import set_engine_enabled
    from torchmetrics_tpu_torch.metric import Metric
    from torchmetrics_tpu_torch.parallel import CollectiveTimeoutError, DelayRank, fault_context, resilience_context

    class FloatSum(Metric):
        full_state_update = False
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        def update(self, x):
            self.total = self.total + x.sum()
        def compute(self):
            return self.total

    set_engine_enabled(True)  # as on the card: the engine carries the sentinel
    gen = torch.Generator().manual_seed(rank)
    mc = MetricCollection({"acc": MulticlassAccuracy(10, device="cpu"), "cm": MulticlassConfusionMatrix(10, device="cpu")})
    for _ in range(3):
        mc.update(torch.randn(64, 10, generator=gen), torch.randint(0, 10, (64,), generator=gen))
    out = {}

    def compute(faults=(), policy=None, late_s=0.0):
        import time
        for m in mc.values(copy_state=False):
            m._computed = None
        dist.barrier()
        time.sleep(late_s)
        with fault_context(*faults), (resilience_context(**policy) if policy else _null()), diag_context() as rec:
            try:
                mc.compute()
                err = None
            except Exception as exc:
                err = type(exc).__name__
        return rec, err

    import contextlib
    _null = contextlib.nullcontext
    set_straggler_threshold_us(15_000)
    with profile_context(every_n=4), sentinel_context(True):
        rec, _ = compute()  # calibrates the clocks
        out["calibrate_meta"] = rec.count("collective")
        # the sentinel: a NaN on rank 1 alone
        s = FloatSum()
        s.update(torch.tensor([float("nan")]) if rank == 1 else torch.ones(1))
        s.compute()
        out["nan_bits"] = read_sentinel(s)["bits"]
        # the audit: each rank's counts differ, and the metric says they must not
        with audit_context(True):
            mc["acc"]._rank_invariant_states = frozenset({"tp"})
            rec, _ = compute()
            mc["acc"]._rank_invariant_states = frozenset()
            out["audit"] = [[e.data["attr"], e.data["flag"]] for e in rec.snapshot() if e.kind == "sync.audit"]
        # the straggler: rank 1 enters the gather 60 ms late
        faults = (DelayRank(rank=1, delay_ms=60, label="meta"),) if rank == 1 else ()
        rec, _ = compute(faults)
        out["straggler"] = [[e.data["rank"], e.data["skew_us"]] for e in rec.snapshot() if e.kind == "sync.straggler"]
        # the genuine in-flight deadline: rank 1 is late for the next sync
        rec, err = compute(policy={"deadline_ms": 500, "retries": 0}, late_s=1.5 if rank == 1 else 0.0)
        out["deadline_error"] = err
        out["degraded"] = [list(e.data["survivors"]) for e in rec.snapshot() if e.kind == "sync.degraded"]
        prov = mc["acc"].__dict__.get("_provenance")
        out["coverage"] = None if prov is None or prov.coverage is None else prov.coverage
        cov = [e.data for e in rec.snapshot() if e.kind == "lineage.coverage"]
        out["coverage_events"] = [[c["members"], c["excluded"]] for c in cov]
    return out
'''


def test_two_ranks_straggler_deadline_sentinel_audit(tmp_path):
    r0, r1 = _two_ranks(tmp_path, _WORLD_BODY)
    assert r0["ok"] and r1["ok"], (r0, r1)
    for r in (r0, r1):
        assert r["calibrate_meta"] >= 3  # the metadata gather runs for a rank-invariant plan
        assert r["nan_bits"] == ["nan"]  # the OR fold carried rank 1's bit to rank 0
        assert ["tp", "rank-invariant-divergence"] in r["audit"]
        assert [s[0] for s in r["straggler"]] == [1] and r["straggler"][0][1] > 15_000
    # rank 0 escaped the in-flight gather and degraded onto the named straggler
    assert r0["deadline_error"] is None and r0["degraded"] == [[0]], r0
    assert r0["coverage_events"] and r0["coverage_events"][-1] == ["0", "1:sync-fault"]
    assert r1["deadline_error"] == "CollectiveTimeoutError"


_VERSION_BODY = '''
def run(rank):
    import torch
    from torchmetrics_tpu_torch import SumMetric
    from torchmetrics_tpu_torch.diag import profile_context, timeline

    if rank == 1:
        timeline.LAYOUT_VERSION = 2  # a rank on another layout
    m = SumMetric(device="cpu")
    m.update(torch.ones(3))
    with profile_context(every_n=4):
        try:
            m.compute()
            return {"raised": None}
        except Exception as exc:
            return {"raised": type(exc).__name__, "message": str(exc)}
'''


def test_two_ranks_layout_version_mismatch_fails_on_both(tmp_path):
    results = _two_ranks(tmp_path, _VERSION_BODY)
    for r in results:
        assert r["ok"] and r["raised"] == "TorchMetricsUserError" and "timeline layout" in r["message"], r
