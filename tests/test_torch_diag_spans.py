"""Spans of the port's flight recorder (``torchmetrics_tpu_torch/diag/trace.py``): nesting,
the bounded store, when they are on, what they cost when off, and the events and
histograms they feed."""

from __future__ import annotations

import collections
import json
import os

import pytest
import torch

from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch import diag as tdiag
from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassCalibrationError,
    MulticlassConfusionMatrix,
)
from torchmetrics_tpu_torch.diag import hist as thist
from torchmetrics_tpu_torch.diag import trace as ttrace
from torchmetrics_tpu_torch.engine import engine_context

C = 6
KW = {"validate_args": False, "device": "cpu"}


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(32, C, generator=g), torch.randint(0, C, (32,), generator=g)


def _collection() -> MetricCollection:
    """Two members that fuse, one that falls back (list states), as the ImageNet suite."""
    return MetricCollection({
        "acc": MulticlassAccuracy(C, average="micro", **KW),
        "cm": MulticlassConfusionMatrix(C, **KW),
        "ece": MulticlassCalibrationError(C, **KW),
    })


def _warm(mc: MetricCollection) -> None:
    for i in range(3):
        mc.update(*_batch(i))
    mc.compute()


@pytest.fixture(autouse=True)
def _no_trace_env(monkeypatch):
    monkeypatch.delenv(ttrace.TRACE_ENV_VAR, raising=False)
    monkeypatch.delenv("TORCHMETRICS_TPU_PROFILE", raising=False)


# ---------------------------------------------------------------- the store


def test_nesting_parent_root_and_self_time():
    rec = ttrace.FlightRecorder()
    with rec.span("outer", "o") as outer:
        with rec.span("a", "o", k=1) as a:
            pass
        with rec.span("b", "o") as b:
            with rec.span("c", "o") as c:
                pass
    assert outer.parent == 0 and outer.root == outer.id
    assert (a.parent, b.parent, c.parent) == (outer.id, outer.id, b.id)
    assert {s.root for s in (a, b, c)} == {outer.id}
    assert a.attrs == {"k": 1} and outer.attrs is None
    assert [s.name for s in rec.spans] == ["a", "c", "b", "outer"]  # stored as they close
    for s in rec.spans:
        assert s.t0 <= s.t1
    spans = list(rec.spans)
    assert ttrace.self_time(outer, spans) == (outer.t1 - outer.t0) - (a.t1 - a.t0) - (b.t1 - b.t0)
    assert ttrace.self_time(b, spans) == (b.t1 - b.t0) - (c.t1 - c.t0)
    assert ttrace.self_time(c, spans) == c.t1 - c.t0
    # a second outermost span starts a new root
    with rec.span("next") as nxt:
        pass
    assert nxt.parent == 0 and nxt.root == nxt.id != outer.id


def test_self_time_counts_overlapping_children_once():
    rec = ttrace.FlightRecorder()
    parent = ttrace.Span(rec, "p", "", None)
    parent.id, parent.t0, parent.t1 = 1, 0, 100
    kids = []
    for i, (t0, t1) in enumerate([(10, 40), (30, 50), (90, 120)]):
        k = ttrace.Span(rec, "k", "", None)
        k.parent, k.t0, k.t1 = 1, t0, t1
        kids.append(k)
    assert ttrace.self_time(parent, kids) == 100 - 40 - 10


def test_span_store_is_bounded_with_a_drop_count():
    rec = ttrace.FlightRecorder(span_capacity=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"]
    assert rec.spans_dropped == 2
    rec.clear()
    assert len(rec.spans) == 0 and rec.spans_dropped == 0
    assert ttrace.process_recorder().span_capacity >= 65536


# ---------------------------------------------------------------- when spans are on


def _names(spans) -> collections.Counter:
    return collections.Counter(s.name for s in spans)


def test_spans_under_diag_context_follow_the_layers():
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        with tdiag.diag_context() as rec:
            mc.update(*_batch(7))
            mc.compute()
            mc.reset()
    spans = list(rec.spans)
    roots = [s for s in spans if s.parent == 0]
    assert [s.name for s in roots] == ["api.update", "api.compute", "api.reset"]
    assert all(s.owner == "MetricCollection" for s in roots)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.root in {r.id for r in roots}
        if s.parent:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    update = [s for s in spans if s.root == roots[0].id]
    names = _names(update)
    for name in ("collection.fused", "collection.views", "engine.key", "engine.stage", "engine.replay",
                 "engine.bind", "eager.update"):
        assert names[name] == 1, (name, names)
    fused = next(s for s in update if s.name == "collection.fused")
    for name in ("engine.key", "engine.stage", "engine.replay", "engine.bind"):
        assert next(s for s in update if s.name == name).parent == fused.id
    assert next(s for s in update if s.name == "engine.replay").attrs["scope"].startswith("tm:fused:")
    eager = next(s for s in update if s.name == "eager.update")
    assert eager.owner == "MulticlassCalibrationError" and eager.attrs == {"reason": "list-state"}
    compute = _names(s for s in spans if s.root == roots[1].id)
    assert compute["epoch.drain"] == compute["epoch.sync"] == 1
    assert compute["epoch.compute"] == 3  # one per group owner and view
    graphs = {s.owner: s.attrs["graph"] for s in spans if s.name == "epoch.compute"}
    assert graphs["MulticlassCalibrationError"] is False and graphs["MulticlassAccuracy"] is True


def test_spans_under_the_trace_variable(monkeypatch):
    with engine_context(True):
        m = MulticlassAccuracy(C, **KW)
        m.update(*_batch(0))
        monkeypatch.setenv(ttrace.TRACE_ENV_VAR, "1")
        m.update(*_batch(1))
        rec = ttrace.active_recorder()
        assert rec is not None
        roots = [s for s in rec.spans if s.parent == 0]
        assert [s.name for s in roots] == ["api.update"] and roots[0].owner == "MulticlassAccuracy"
        assert {"engine.key", "engine.stage", "engine.replay", "engine.bind"} <= set(_names(rec.spans))
        # the variable is read when the next outermost call begins
        monkeypatch.setenv(ttrace.TRACE_ENV_VAR, "0")
        before = len(rec.spans)
        m.update(*_batch(2))
        assert ttrace.active_recorder() is None and len(rec.spans) == before


def test_spans_under_the_torch_profiler_go_to_the_process_recorder():
    proc = ttrace.process_recorder()
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        proc.clear()
        mc.update(*_batch(4))
        assert len(proc.spans) == 0  # off: nothing records
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            mc.update(*_batch(5))
            mc.compute()
        n = len(proc.spans)
        assert [s.name for s in proc.spans if s.parent == 0] == ["api.update", "api.compute"]
        assert _names(proc.spans)["eager.update"] == 1 and proc.spans_dropped == 0
        assert proc.counts == collections.Counter()  # events never go there
        mc.update(*_batch(6))
        assert len(proc.spans) == n


def test_the_process_recorder_holds_one_profiling_session():
    proc = ttrace.process_recorder()
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        for session in range(2):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                mc.update(*_batch(10 + session))
                mc.update(*_batch(20 + session))
            assert [s.name for s in proc.spans if s.parent == 0] == ["api.update", "api.update"]
            mc.update(*_batch(30 + session))  # unprofiled: the next session starts afresh


def test_a_metric_inside_a_call_opens_no_api_span():
    with engine_context(True), tdiag.diag_context() as rec:
        m = MulticlassAccuracy(C, **KW)
        m(*_batch(0))
        m.compute()
    roots = [s for s in rec.spans if s.parent == 0]
    assert [s.name for s in roots] == ["api.forward", "api.compute"]
    assert _names(rec.spans)["api.update"] == 0 and _names(rec.spans)["epoch.compute"] >= 2


# ---------------------------------------------------------------- off


def test_spans_off_read_the_environment_once_per_call(monkeypatch):
    proc = ttrace.process_recorder()
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        m = MulticlassAccuracy(C, **KW)
        m.update(*_batch(0))
        m.compute()
        counts: collections.Counter = collections.Counter()
        real_get = os.environ.get

        def counting_get(key, default=None):
            counts[key] += 1
            return real_get(key, default)

        monkeypatch.setattr(os.environ, "get", counting_get)
        stored = len(proc.spans)
        for name, fn in (("update", lambda: mc.update(*_batch(1))), ("compute", mc.compute),
                         ("metric update", lambda: m.update(*_batch(2))), ("metric compute", m.compute),
                         ("metric forward", lambda: m(*_batch(3)))):
            counts.clear()
            fn()
            assert counts[ttrace.TRACE_ENV_VAR] <= 1, (name, counts)
            assert counts["TORCHMETRICS_TPU_PROFILE"] <= 1, (name, counts)
        assert len(proc.spans) == stored
    assert ttrace._CALL.depth == 0 and ttrace._CALL.open is None


def test_span_sites_off_are_shared_no_ops():
    assert ttrace.span("x") is ttrace.span("y")
    with ttrace.span("x") as sp:
        assert sp is None


def test_profile_alone_times_spans_for_the_histograms_and_keeps_none():
    proc = ttrace.process_recorder()
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        proc.clear()
        thist.reset_histograms()
        with tdiag.profile_context(every_n=1000):
            mc.update(*_batch(9))
    series = {(r["owner"], r["kind"], r["series"]) for r in thist.histograms_snapshot()}
    assert ("MetricCollection", "collection", "dispatch_us") in series
    assert ("MulticlassCalibrationError", "eager", "dispatch_us") in series
    assert len(proc.spans) == 0


# ---------------------------------------------------------------- events fed by spans


# the kinds and fields the timing blocks that the spans replaced recorded
EVENT_FIELDS = {
    "collection.step": {"dispatch_us", "owners", "fused"},
    "fused.dispatch": {"dispatch_us", "bucketed", "pad_rows", "bytes", "members", "cached"},
    "update.eager": {"dispatch_us"},
}


def test_dispatch_events_and_histograms_keep_their_kinds_and_fields():
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        thist.reset_histograms()
        with tdiag.diag_context() as rec:
            mc.update(*_batch(11))
    events = [e for e in rec.snapshot() if e.kind in EVENT_FIELDS]
    assert collections.Counter(e.kind for e in events) == {k: 1 for k in EVENT_FIELDS}
    for e in events:
        assert set(e.data) == EVENT_FIELDS[e.kind], e
        assert e.data["dispatch_us"] > 0
    data = {e.kind: e.data for e in events}
    assert data["collection.step"]["owners"] == 3 and data["collection.step"]["fused"] == 2
    assert data["fused.dispatch"]["members"] == 2 and data["fused.dispatch"]["cached"] is True
    spans = {s.name: s for s in rec.spans}
    assert data["collection.step"]["dispatch_us"] == spans["api.update"].duration_us
    assert data["update.eager"]["dispatch_us"] == spans["eager.update"].duration_us
    replay, bind = spans["engine.replay"], spans["engine.bind"]
    assert data["fused.dispatch"]["dispatch_us"] == round((bind.t1 - replay.t0) / 1e3, 3)
    series = {(r["owner"], r["kind"], r["series"]) for r in thist.histograms_snapshot()}
    fused_owner = mc._fused_engine.stats.owner
    assert {("MetricCollection", "collection", "dispatch_us"), (fused_owner, "fused", "dispatch_us"),
            ("MulticlassCalibrationError", "eager", "dispatch_us")} <= series


def test_chrome_trace_holds_the_spans_as_nested_slices(tmp_path):
    with engine_context(True):
        mc = _collection()
        _warm(mc)
        with tdiag.diag_context() as rec:
            mc.update(*_batch(12))
            mc.compute()
    path = tmp_path / "trace.json"
    n = tdiag.export_chrome_trace(str(path), rec)
    assert n == len(rec.snapshot())
    out = json.loads(path.read_text())["traceEvents"]
    slices = [e for e in out if e.get("pid") == 1 and e["ph"] == "X"]
    assert len(slices) == len(rec.spans)
    by_id = {e["args"]["id"]: e for e in slices}
    for e in slices:
        if e["args"]["parent"]:
            p = by_id[e["args"]["parent"]]
            assert p["ts"] - 1e-3 <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 2e-3
    tracks = {e["args"]["name"] for e in out if e.get("pid") == 1 and e["name"] == "thread_name"}
    assert {"MetricCollection", "MulticlassCalibrationError"} <= tracks
    assert not [e for e in out if e.get("pid") == 0 and e.get("name", "").startswith(("api.", "engine."))]
