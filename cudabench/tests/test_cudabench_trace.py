"""Reading the profiler's trace: attribution to spans, the union of busy intervals,
the idle gaps and the per-layer readers on a trace made by hand."""

import pytest
import torch

from cudabench.harness import spec, trace, window
from cudabench.harness.cell import Traced

IMAGENET = spec.load_module(spec.BENCH_DIR / "configs" / "imagenet1k_suite.py")


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    {"ph": "M", "name": "process_name"},
    _x("user_annotation", "cudabench.update", 0, 10),
    _x("user_annotation", "cudabench.update", 20, 10),
    _x("user_annotation", "cudabench.compute", 40, 20),
    _x("user_annotation", "other", 0, 100),
    _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),
    _x("cuda_runtime", "cudaGraphLaunch", 25, 1, corr=2),
    _x("cuda_runtime", "cudaMemcpyAsync", 45, 1, corr=3),
    _x("kernel", "void stat_counts_kernel<float, true>(...)", 12, 6, corr=1),
    _x("kernel", "sort", 31, 6, corr=2),
    _x("kernel", "index_add", 33, 6, corr=2),  # overlaps the sort: counted once
    _x("gpu_memcpy", "Memcpy DtoH", 50, 5, corr=3),
    _x("kernel", "late", 58, 10, corr=99),  # unknown launch, clipped to the window
]


def test_parse_attributes_and_unions():
    t = trace.parse(EVENTS)
    assert t.window == (0.0, 60.0)
    assert [op.span for op in t.ops] == [("update", 0), ("update", 1), ("update", 1), ("compute", 0), None]
    assert t.busy_us == 6 + 8 + 5 + 2
    assert t.ops[-1].t1 == 60.0
    assert t.gaps == [(0.0, 12.0), (18.0, 31.0), (39.0, 50.0), (55.0, 58.0)]


def test_breakdown_names_gaps_by_host_span():
    b = trace.parse(EVENTS).breakdown()
    assert b["idle_gaps"][0] == ["update", pytest.approx(13e-6)]
    assert b["idle_gaps"][1] == ["update", pytest.approx(12e-6)]
    assert b["idle_gaps"][2] == ["compute", pytest.approx(11e-6)]
    assert b["device_ops"][0][1] == pytest.approx(6e-6)
    assert len(b["device_ops"]) <= trace.TOP and len(b["idle_gaps"]) <= trace.TOP


def test_parse_needs_the_spans():
    with pytest.raises(RuntimeError):
        trace.parse([_x("kernel", "k", 0, 1, corr=1)])


def test_merge():
    assert trace.merge([(3, 4), (0, 2), (1, 3), (6, 7)]) == [(0, 4), (6, 7)]


def _traced(events, spans, batches):
    rec = trace.Recorder(False)
    rec.spans = spans
    cell = spec.resolve("imagenet1k_suite.b4096")
    res = window.WindowResult(calls=len([s for s in spans if s.kind == "update"]), syncs_in_calls=3, syncs_counted=True)
    return Traced(cell, cell.config, rec, trace.parse(events) if events else None, res, batches,
                  {"replays": 6, "eager_fallbacks": 2}, hbm_bytes_per_s=1e9)


def _read(name, tr):
    return spec.load_module(spec.BENCH_DIR / "layer_metrics" / f"{name}.py").read(tr)


def _batches():
    data = {"logits": torch.empty(4000, 1000, device="meta"), "target": torch.empty(4000, dtype=torch.int64, device="meta")}
    return {0: IMAGENET.batch(data, (0, 0, 1000)), 1: IMAGENET.batch(data, (1, 1000, 500))}


SPANS = [trace.HostSpan("update", 0, 4e-6, {"batch": 0}), trace.HostSpan("update", 1, 2e-6, {"batch": 1}),
         trace.HostSpan("compute", 0, 1e-3, {}), trace.HostSpan("epoch_read", 0, 2e-3, {})]


def test_readers_on_a_hand_made_trace():
    batches = _batches()
    tr = _traced(EVENTS, SPANS, batches)
    assert _read("device_idle_pct", tr) == pytest.approx(100 * (1 - 21 / 60))
    assert _read("host_enqueue_us", tr) == pytest.approx(3.0)
    assert _read("compute_ms", tr) == pytest.approx(3.0)
    assert _read("engine_replay_share", tr) == pytest.approx(75.0)
    assert _read("host_syncs_per_update", tr) == pytest.approx(1.5)
    k1 = IMAGENET.k1_bytes(batches[0]) / 1e9 / 6e-6
    assert _read("k1_roofline_pct", tr) == pytest.approx(100 * k1)
    cfg = tr.cfg
    need = sum(IMAGENET.input_bytes(b) + IMAGENET.state_bytes(cfg, b) for b in batches.values()) / 1e9
    assert _read("update_roofline_pct", tr) == pytest.approx(100 * need / (6e-6 + 8e-6))


def test_readers_return_nothing_when_nothing_was_read():
    events = [e for e in EVENTS if "stat_counts" not in e.get("name", "")]
    tr = _traced(events, SPANS, _batches())
    assert _read("k1_roofline_pct", tr) is None
    tr = _traced(None, SPANS[:2], _batches())
    for name in ("device_idle_pct", "k1_roofline_pct", "update_roofline_pct", "compute_ms"):
        assert _read(name, tr) is None
    tr.engine = {}
    assert _read("engine_replay_share", tr) is None
    tr.result.syncs_counted = False
    assert _read("host_syncs_per_update", tr) is None
