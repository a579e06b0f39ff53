"""The ``program_span`` readers: the program's own spans aligned to the profiler's trace,
on traced runs at small sizes on the CPU (the engine forced on, as it is on the card)
and on spans and traces made by hand."""

import gc
import time
import weakref
from types import SimpleNamespace

import pytest
import torch

from _small import CELLS, small_cell
from cudabench.harness import cell as cell_mod
from cudabench.harness import spec, trace
from cudabench.layer_metrics import _program_spans

CPU = torch.device("cpu")
NEW = ("api_update_us", "engine_stage_us", "eager_update_us", "api_compute_ms", "idle_in_program_pct",
       "input_copy_mb_per_call")


def _read(name, tr):
    return spec.load_module(spec.BENCH_DIR / "layer_metrics" / f"{name}.py").read(tr)


def _traced_run(name, monkeypatch):
    """A traced run of the small cell: its metrics and the ``Traced`` its readers read."""
    from torchmetrics_tpu_torch.engine import engine_context

    cell, sizes = small_cell(name)
    seen = {}
    real = cell_mod._per_layer

    def keep(c, tr):
        seen["tr"] = tr
        return real(c, tr)

    monkeypatch.setattr(cell_mod, "_per_layer", keep)
    with engine_context(True):
        out = cell_mod.run_cell(cell, 2**31 + 29, 0.3, True, CPU, time.perf_counter(), sizes=sizes)
    assert out.correct
    return cell, out.metrics, seen["tr"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_every_new_metric(name, monkeypatch):
    cell, metrics, tr = _traced_run(name, monkeypatch)
    listed = [m["name"] for m in cell.per_layer if m["name"].split(".")[0] in NEW]
    assert listed
    for m in listed:
        assert isinstance(metrics.get(m, {}).get("value"), float), (m, metrics.get(m))
    value = {k.split(".")[0]: v["value"] for k, v in metrics.items()}
    assert value["api_update_us"] <= value["host_enqueue_us"]
    if "eager_update_us" in value:
        assert value["engine_stage_us"] + value["eager_update_us"] <= value["api_update_us"]
    else:
        assert value["engine_stage_us"] <= value["api_update_us"]
    if "api_compute_ms" in value:
        assert value["api_compute_ms"] <= value["compute_ms"]
    assert value["input_copy_mb_per_call"] > 0

    # every program root span of the window lies inside a benchmark span once aligned
    a = _program_spans.aligned(tr)
    annotations = tr.trace.annotations
    assert a.intervals
    for t0, t1 in a.intervals:
        assert any(a0 - _program_spans.TOLERANCE_US <= t0 and t1 <= a1 + _program_spans.TOLERANCE_US
                   for a0, a1, _ in annotations)
    calls = [c for c in a.calls if c[2] in ("update", "forward")]
    assert len(calls) == len(tr.calls())
    assert all(roots for roots in a.roots)
    if cell.config_name == "deepseek_v3_vocab_eval":  # accuracy and perplexity: two roots a call
        assert all(len(roots) == 2 for roots in a.roots)


# ---------------------------------------------------------------- by hand


def _span(i, name, t0_us, t1_us, parent=0, root=None):
    return SimpleNamespace(id=i, parent=parent, root=root or i, name=name, t0=int(t0_us * 1e3), t1=int(t1_us * 1e3))


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "cudabench." + name, "ts": ts, "dur": dur}


# two update calls (two roots each, as the vocabulary cell makes), a compute and a reset;
# the program's clock runs 1,000,000 µs behind the trace's, and each call's roots start
# 2 µs after it and end 2 µs before it
EVENTS = [_x("update", 100, 50), _x("update", 200, 50), _x("compute", 300, 80), _x("reset", 400, 10),
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 120, "dur": 100, "args": {"correlation": 1}}]
BASE = -1_000_000


def _spans():
    return [
        _span(1, "api.update", BASE + 102, BASE + 120), _span(2, "engine.stage", BASE + 104, BASE + 110, 1, 1),
        _span(3, "api.update", BASE + 122, BASE + 148), _span(4, "engine.stage", BASE + 124, BASE + 128, 3, 3),
        _span(5, "api.update", BASE + 202, BASE + 230), _span(6, "eager.update", BASE + 205, BASE + 225, 5, 5),
        _span(7, "api.update", BASE + 232, BASE + 248),
        _span(8, "api.compute", BASE + 302, BASE + 378),
        _span(9, "api.reset", BASE + 402, BASE + 408),
    ]


class _Rec:
    def __init__(self, spans, dropped=0):
        self.spans, self.spans_dropped = spans, dropped


class _Tr(SimpleNamespace):
    """A stand-in for the harness's ``Traced`` (which, unlike a plain namespace, can be
    weakly referenced)."""


def _tr(events=EVENTS):
    return _Tr(trace=trace.parse(events), engine={"input_copy_bytes": 4_000_000}, result=SimpleNamespace(calls=2))


def _inside(a, tolerance=0.0):
    return all(c0 - tolerance <= a.at(r.t0) and a.at(r.t1) <= c1 + tolerance
               for (c0, c1, _), roots in zip(a.calls, a.roots) for r in roots)


def test_alignment_pairs_each_call_with_its_roots(monkeypatch):
    monkeypatch.setattr(_program_spans, "_recorder", lambda: _Rec(_spans()))
    tr = _tr()
    a = _program_spans.aligned(tr)
    assert a.slope == pytest.approx(1.0) and a.at(0) == pytest.approx(-BASE)  # 2 µs of room on both sides
    assert [[r.id for r in roots] for roots in a.roots] == [[1, 3], [5, 7], [8], [9]]
    assert len(a.intervals) == 6
    assert _read("api_update_us", tr) == pytest.approx((44 + 44) / 2)
    assert _read("engine_stage_us", tr) == pytest.approx((10 + 0) / 2)
    assert _read("eager_update_us", tr) == pytest.approx((0 + 20) / 2)
    assert _read("api_compute_ms", tr) == pytest.approx(76e-3)
    assert _read("input_copy_mb_per_call", tr) == pytest.approx(2.0)
    # over the window (100 to 410) the card idles in [100, 120] and [220, 410]; mapped,
    # the roots cover 102-120, 220-230, 232-248, 302-378 and 402-408 of it
    idle = 20 + 190
    inside = 18 + 10 + 16 + 76 + 6
    assert _read("idle_in_program_pct", tr) == pytest.approx(100 * inside / idle)


def test_a_host_clock_that_drifts_from_the_trace_still_aligns(monkeypatch):
    """The host clock runs 30 ppm slow against the trace's over a 4 s window: 120 µs by
    its end, more than any constant offset absorbs, as every call's roots leave it 2 µs
    of room at each end."""
    events, spans = [], []
    for k in range(2000):
        a0 = 1000 + 2000 * k
        events.append(_x("update", a0, 1500))
        t0, t1 = (a0 + 2) / (1 + 30e-6), (a0 + 1498) / (1 + 30e-6)
        spans.append(_span(k + 1, "api.update", BASE + t0, BASE + t1))
    monkeypatch.setattr(_program_spans, "_recorder", lambda: _Rec(spans))
    a = _program_spans.aligned(_tr(events))
    assert a is not None and a.slope == pytest.approx(1 + 30e-6, abs=1e-9)
    assert _inside(a)


def test_a_late_first_call_and_short_first_roots_still_align(monkeypatch):
    """The first call under the profiler starts its roots ~0.1 ms late (as on the card),
    and each call's first root is shorter than that."""
    events, spans = [], []
    for k in range(5):
        a0 = 1000 + 500 * k
        events.append(_x("update", a0, 400))
        lag = 102 if k == 0 else 2
        spans.append(_span(10 * k + 1, "api.update", BASE + a0 + lag, BASE + a0 + lag + 30))
        spans.append(_span(10 * k + 2, "api.update", BASE + a0 + lag + 35, BASE + a0 + lag + 235))
    monkeypatch.setattr(_program_spans, "_recorder", lambda: _Rec(spans))
    a = _program_spans.aligned(_tr(events))
    assert a is not None and _inside(a)
    assert [[r.id for r in roots] for roots in a.roots] == [[10 * k + 1, 10 * k + 2] for k in range(5)]


def test_a_call_whose_first_root_waits_on_the_card_still_aligns(monkeypatch):
    """In the vocabulary cell a call's first root can wait ~11 ms on the card's queue
    before its second starts."""
    events, spans = [], []
    for k in range(20):
        a0 = 1000 + 500 * k
        wait = 11_000 if k == 19 else 0
        events.append(_x("update", a0, 237 + wait))
        spans.append(_span(10 * k + 1, "api.update", BASE + a0 + 2, BASE + a0 + 32 + wait))
        spans.append(_span(10 * k + 2, "api.update", BASE + a0 + 35 + wait, BASE + a0 + 235 + wait))
    monkeypatch.setattr(_program_spans, "_recorder", lambda: _Rec(spans))
    a = _program_spans.aligned(_tr(events))
    assert a is not None and _inside(a)
    assert [[r.id for r in roots] for roots in a.roots] == [[10 * k + 1, 10 * k + 2] for k in range(20)]


def test_a_root_that_starts_soonest_still_lies_inside_its_call(monkeypatch):
    """Most calls' roots start 60 µs in, one 2 µs in: a map fitted to the starts alone
    would put that one 58 µs before its call; the offset leaves every root inside."""
    events, spans = [], []
    for k in range(9):
        a0 = 1000 + 500 * k
        events.append(_x("update", a0, 400))
        lag = 2 if k == 4 else 60
        spans.append(_span(k + 1, "api.update", BASE + a0 + lag, BASE + a0 + lag + 300))
    monkeypatch.setattr(_program_spans, "_recorder", lambda: _Rec(spans))
    a = _program_spans.aligned(_tr(events))
    assert a is not None and _inside(a)


def test_a_run_is_aligned_once_and_not_kept_alive(monkeypatch):
    calls = []
    monkeypatch.setattr(_program_spans, "_recorder", lambda: calls.append(1) or _Rec(_spans()))
    tr = _tr()
    assert _program_spans.aligned(tr) is _program_spans.aligned(tr) and len(calls) == 1
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None


@pytest.mark.parametrize("case", ["no_program_spans", "dropped", "missing_root", "outside", "wrong_kind",
                                  "another_window"])
def test_readers_return_nothing_when_the_spans_do_not_align(case, monkeypatch):
    spans = _spans()
    rec = _Rec(spans)
    if case == "no_program_spans":
        rec = None
    elif case == "dropped":
        rec.spans_dropped = 1
    elif case == "missing_root":
        rec.spans = [s for s in spans if s.id != 8]
    elif case == "outside":  # the reset's root ends 150 µs past its benchmark span
        spans[-1].t1 += 150_000
    elif case == "wrong_kind":  # a compute root inside the first update's benchmark span
        spans.append(_span(10, "api.compute", BASE + 140, BASE + 145))
    elif case == "another_window":  # the roots of a window 5 s earlier, as if never emptied
        rec.spans = [_span(100 + s.id, s.name, s.t0 / 1e3 - 5e6, s.t1 / 1e3 - 5e6)
                     for s in spans if s.parent == 0] + spans
    monkeypatch.setattr(_program_spans, "_recorder", lambda: rec)
    tr = _tr()
    for name in ("api_update_us", "engine_stage_us", "eager_update_us", "api_compute_ms", "idle_in_program_pct"):
        assert _read(name, tr) is None, name
