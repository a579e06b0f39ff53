"""Diag reporting: events and engine counters merged; JSON and chrome-trace export
(counterpart of ``torchmetrics_tpu/diag/report.py``, with the JAX keys).

Three consumers, one data path:

- :func:`diag_report` merges the process-wide engine counters
  (:func:`~torchmetrics_tpu_torch.engine.stats.engine_report`) with the flight
  recorder's event stream into one per-metric timing/counter report — the
  "what did my epoch actually cost" dict.
- :func:`export_json` dumps the raw event stream (for offline diffing and the
  counter-regression tooling).
- :func:`export_chrome_trace` writes the events in the Chrome Trace Event
  format (``{"traceEvents": [...]}``), loadable in Perfetto
  (https://ui.perfetto.dev) — dispatch/step events with a measured
  ``dispatch_us`` become duration ("X")
  slices on a per-owner track; everything else becomes an instant ("i")
  marker. Durations are HOST-side spans (async launch + Python bookkeeping);
  device kernel time belongs to sampled ``device_us`` probes and to
  ``torch.profiler`` traces, where the engines' ``tm:<owner>:<kind>:<signature>``
  scopes (``diag/profile.dispatch_scope``) sit alongside. The recorder's spans
  (``diag/trace.py``) follow as complete slices with their real start and end, on a
  second process (pid 1, "torchmetrics_tpu spans"), one track per owner.
  Multi-rank streams merge into one trace via
  :func:`torchmetrics_tpu_torch.diag.timeline.merge_timelines`.
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.diag.trace import FlightRecorder, TraceEvent, active_recorder

__all__ = ["diag_report", "export_chrome_trace", "export_json"]

# kinds whose events carry dispatch_us and render as duration slices.
# update.scan is ONE drained scan (its args carry the steps folded): the
# chrome trace renders one X-slice per drain, never K phantom per-step slices
_SPAN_KINDS = frozenset(
    {"update.dispatch", "fused.dispatch", "compute.dispatch", "collection.step", "sync.exchange", "update.scan"}
)


def _events_of(recorder: Optional[FlightRecorder]) -> List[TraceEvent]:
    rec = recorder if recorder is not None else active_recorder()
    return rec.snapshot() if rec is not None else []


def diag_report(recorder: Optional[FlightRecorder] = None, reset: bool = False) -> Dict[str, Any]:
    """One merged observability dict: engine counters + event aggregation.

    Returns::

        {
          "counters": engine_report(),          # process-wide EngineStats sums
          "events": {kind: count},              # exact, drop-proof
          "dropped": int,                       # ring-buffer overflow count
          "per_metric": {owner: {"dispatches", "dispatch_us", "device_us",
                                 "probes", "traces", "retraces",
                                 "fallbacks"}},
          "retraces": [{"owner", "kind", "cause"}],   # every recorded retrace
          "host_transfers": int,                # transfer.host + transfer.blocked
          "collective_bytes": int,              # bytes through sanctioned collectives
          "ledger": {...},                      # cost ledger totals (diag/costs.py)
          "sentinels": [...],                   # per-metric health bitmasks (diag/sentinel.py)
          "histograms": [...],                  # latency/size distributions (diag/hist.py):
                                                # per (owner, kind, series) p50/p90/p99
          "profile": {...},                     # sampled-probe accounting (diag/profile.py)
          "provenance": {...},                  # lineage watermarks (diag/lineage.py)
        }

    Naming: ``dispatch_us`` is HOST wall-time around the **async** dispatch —
    the launch cost, NOT device time. True completion latency lives in ``device_us``,
    populated only by sampled profiling probes (``profile_context`` /
    ``TORCHMETRICS_TPU_PROFILE``).

    Dict sections are deterministically sorted so two reports of the same
    state serialize byte-identically (the counter gate diffs JSON exports).

    ``reset=True`` clears every surface this report covers afterwards — the
    engine counters, THIS report's recorder (the explicitly passed one, or the
    active one when none is passed; never an unrelated recorder that merely
    happens to be active), the cost ledger, the sentinel registry, the
    histograms, and the probe accounting — so a later report never attributes
    this run's compiles or flags to the next.
    """
    from torchmetrics_tpu_torch.engine.stats import engine_report, reset_engine_counters

    rec = recorder if recorder is not None else active_recorder()
    events = rec.snapshot() if rec is not None else []
    counts: Counter = Counter(rec.counts) if rec is not None else Counter()

    per_metric: Dict[str, Dict[str, Any]] = defaultdict(
        lambda: {
            "dispatches": 0, "dispatch_us": 0.0, "device_us": 0.0, "probes": 0,
            "traces": 0, "retraces": 0, "fallbacks": 0,
            "scan_dispatches": 0, "scan_steps_folded": 0,
        }
    )
    retraces: List[Dict[str, Any]] = []
    collective_bytes = 0
    for ev in events:
        slot = per_metric[ev.owner or "<process>"]
        if ev.kind == "update.scan":
            # one drained scan = one dispatch folding `steps` updates; the
            # per-owner amortization factor derives below
            slot["dispatches"] += 1
            slot["dispatch_us"] += float(ev.data.get("dispatch_us", 0.0))
            slot["scan_dispatches"] += 1
            slot["scan_steps_folded"] += int(ev.data.get("steps", 0))
        elif ev.kind in _SPAN_KINDS:
            slot["dispatches"] += 1
            slot["dispatch_us"] += float(ev.data.get("dispatch_us", 0.0))
        elif ev.kind.endswith(".probe"):
            slot["probes"] += 1
            slot["device_us"] += float(ev.data.get("device_us", 0.0))
        elif ev.kind.endswith(".trace"):
            slot["traces"] += 1
        elif ev.kind.endswith(".retrace") or ev.kind.endswith("fold_retrace"):
            slot["retraces"] += 1
            retraces.append({"owner": ev.owner, "kind": ev.kind, "cause": ev.data.get("cause", "")})
        elif ev.kind == "fallback":
            slot["fallbacks"] += 1
        elif ev.kind == "collective":
            collective_bytes += int(ev.data.get("bytes", 0))
    from torchmetrics_tpu_torch.diag.costs import ledger_snapshot
    from torchmetrics_tpu_torch.diag.hist import histograms_snapshot
    from torchmetrics_tpu_torch.diag.lineage import lineage_snapshot
    from torchmetrics_tpu_torch.diag.profile import profile_snapshot
    from torchmetrics_tpu_torch.diag.sentinel import sentinel_report

    for slot in per_metric.values():
        # dispatch-amortization factor: real steps folded per scan dispatch
        # (1.0 would be the unqueued engine; the K-fold win reads directly)
        slot["scan_amortization"] = (
            round(slot["scan_steps_folded"] / slot["scan_dispatches"], 2)
            if slot["scan_dispatches"]
            else 0.0
        )

    out: Dict[str, Any] = {
        "counters": engine_report(),
        "events": {k: counts[k] for k in sorted(counts)},
        "dropped": rec.dropped if rec is not None else 0,
        "per_metric": {k: dict(per_metric[k]) for k in sorted(per_metric)},
        "retraces": retraces,
        "host_transfers": counts.get("transfer.host", 0) + counts.get("transfer.blocked", 0),
        "collective_bytes": collective_bytes,
        "ledger": ledger_snapshot()["totals"],
        "sentinels": sentinel_report(),
        "histograms": histograms_snapshot(),
        "profile": profile_snapshot(),
        "provenance": lineage_snapshot(),
    }
    if reset:
        from torchmetrics_tpu_torch.diag.costs import reset_ledger
        from torchmetrics_tpu_torch.diag.hist import reset_histograms
        from torchmetrics_tpu_torch.diag.lineage import reset_lineage
        from torchmetrics_tpu_torch.diag.profile import reset_profile
        from torchmetrics_tpu_torch.diag.sentinel import reset_sentinels

        reset_engine_counters()
        if rec is not None:
            rec.clear()
        reset_ledger()
        reset_sentinels()
        reset_histograms()
        reset_profile()
        # lockstep with reset_engine_stats: a stale watermark would attribute
        # the previous run's backlog to the fresh one as phantom staleness
        reset_lineage()
    return out


def export_json(path: str, recorder: Optional[FlightRecorder] = None) -> int:
    """Write the raw event stream as a JSON list; returns the event count."""
    events = _events_of(recorder)
    payload = [
        {"seq": ev.seq, "ts_us": round(ev.ts * 1e6, 3), "kind": ev.kind, "owner": ev.owner, **ev.data}
        for ev in events
    ]
    with open(path, "w") as fh:
        json.dump(payload, fh, default=str)
    return len(payload)


def export_chrome_trace(path: str, recorder: Optional[FlightRecorder] = None) -> int:
    """Write the events as a Perfetto-loadable chrome trace; returns the count.

    Layout: one process (pid 0, "torchmetrics_tpu"), one thread track per event
    owner. Events with a measured ``dispatch_us``
    become complete ("X") slices ending at their record timestamp; the rest
    are thread-scoped instants.
    Packed-sync ``collective`` events get a dedicated per-role track
    (``collective:reduce:int32``, ``collective:meta``, …) with their byte
    counts in ``args``, so sync cost sits visually next to compute cost
    instead of vanishing into the anonymous process track.

    The recorder's spans become complete ("X") slices from their ``t0`` to their
    ``t1``, on the same clock as the events, in a second process (pid 1), one track
    per owner; ``args`` carry ``id``, ``parent``, ``root`` and the span's attributes,
    and a child lies inside its parent's interval.
    """
    rec = recorder if recorder is not None else active_recorder()
    events = rec.snapshot() if rec is not None else []
    tids: Dict[str, int] = {}
    trace_events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "torchmetrics_tpu"}}
    ]
    for ev in events:
        if ev.kind == "collective":
            owner = "collective:" + str(ev.data.get("label") or "?")
        else:
            owner = ev.owner or "<process>"
        tid = tids.setdefault(owner, len(tids) + 1)
        ts_us = ev.ts * 1e6
        dur = float(ev.data.get("dispatch_us", 0.0))
        entry: Dict[str, Any] = {
            "name": ev.kind,
            "pid": 0,
            "tid": tid,
            "args": {k: (v if isinstance(v, (int, float, bool, str)) else str(v)) for k, v in ev.data.items()},
        }
        if ev.kind in _SPAN_KINDS and dur > 0.0:
            # recorded AFTER the span: the slice ends at ev.ts
            entry.update(ph="X", ts=round(ts_us - dur, 3), dur=round(dur, 3))
        else:
            entry.update(ph="i", ts=round(ts_us, 3), s="t")
        trace_events.append(entry)
    for owner, tid in tids.items():
        trace_events.append(
            {"ph": "M", "pid": 0, "tid": tid, "name": "thread_name", "args": {"name": owner}}
        )
    spans = list(rec.spans) if rec is not None else []
    if spans:
        trace_events.append({"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "torchmetrics_tpu spans"}})
        span_tids: Dict[str, int] = {}
        base_us = rec.t0 * 1e6
        for sp in sorted(spans, key=lambda x: (x.t0, -x.t1)):
            tid = span_tids.setdefault(sp.owner or "<process>", len(span_tids) + 1)
            args = {"id": sp.id, "parent": sp.parent, "root": sp.root}
            args.update({k: (v if isinstance(v, (int, float, bool, str)) else str(v)) for k, v in (sp.attrs or {}).items()})
            trace_events.append({
                "name": sp.name, "ph": "X", "pid": 1, "tid": tid, "ts": round(sp.t0 / 1e3 - base_us, 3),
                "dur": round((sp.t1 - sp.t0) / 1e3, 3), "args": args,
            })
        for owner, tid in span_tids.items():
            trace_events.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name", "args": {"name": owner}})
    with open(path, "w") as fh:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, fh)
    return len(events)
