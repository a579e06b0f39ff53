"""Cross-rank timeline merge and packed-sync straggler detection (counterpart of
``torchmetrics_tpu/diag/timeline.py``, copied: the Perfetto output is byte-identical for
identical inputs).

A multi-chip epoch produces one event stream per rank, each on its own host
clock. Looking at them separately hides exactly the question that matters at
pod scale: *who is late into the packed sync, and by how much?* This module
turns the per-rank streams into one picture:

- **Clock-offset estimation from the packed-sync barrier.** Each rank stamps
  two timestamps into the packed sync's existing int32 metadata gather
  (``parallel/packing.py``; zero extra collectives): its *previous* barrier
  exit (``prev_post``) and its *current* barrier arrival (``arrival``), both
  on the :func:`~torchmetrics_tpu_torch.diag.profile.epoch_now_us` clock. The port
  stamps the arrival as the rank enters the gather (after any planted delay of
  ``parallel/faults.py``), not when it builds the row. All ranks
  exit a collective at approximately the same true instant, so the gathered
  ``prev_post`` stamps are simultaneous events observed on different clocks —
  their pairwise differences ARE the clock offsets (to within one collective's
  exit jitter). The entries are **layout-versioned**: a rank gathering a
  mismatched version (profiling enabled on some ranks only, or a future layout
  change) fails loud on every rank instead of mis-parsing silently.
- **Straggler attribution.** Offset-corrected arrivals put every rank's
  barrier entry on one clock: the last arrival is the straggler, and
  ``skew_us = last - first`` is how long the world waited for it. The epoch
  engine turns a skew past the configurable threshold
  (:func:`~torchmetrics_tpu_torch.diag.profile.straggler_threshold_us`) into a
  ``sync.straggler`` flight-recorder event (rank + skew) and an
  ``EngineStats.sync_straggler_flags`` count.
- **:func:`merge_timelines`** renders N per-rank event streams as ONE
  Perfetto-loadable chrome trace: one *process* track per rank (pid = rank),
  per-owner thread tracks inside it, clock offsets applied, deterministic
  ordering — byte-identical JSON for identical inputs.

First-sync caveat: ``prev_post`` is 0 until a rank has completed one packed
sync, so the first exchange reports arrivals uncorrected (offsets all zero).
That is the honest choice — an uncalibrated skew is attributed to clock
offset, not to a phantom straggler.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from torchmetrics_tpu_torch.diag import profile as _profile

__all__ = [
    "LAYOUT_VERSION",
    "TIMELINE_META_INTS",
    "merge_timelines",
    "resolve_arrivals",
    "stamp_arrival",
    "timeline_entries",
]

#: bump when the metadata piggyback layout changes; gathered versions must
#: agree on every rank (asymmetric profiling enablement fails loud here)
LAYOUT_VERSION = 1

#: ints appended to the packed-sync metadata per rank: [version, prev_post, arrival]
TIMELINE_META_INTS = 3

_MASK = 0x7FFFFFFF  # int32-positive µs stamps; wrap period ~35.8 minutes
_HALF = 1 << 30  # wrap-correction threshold for stamp differences


def timeline_entries() -> List[int]:
    """The int32 triple this rank stamps into the metadata gather."""
    return [
        LAYOUT_VERSION,
        _profile.last_sync_exit_us() & _MASK,
        _profile.epoch_now_us() & _MASK,
    ]


def stamp_arrival(meta_row: np.ndarray) -> np.ndarray:
    """Copy of a local metadata row with the arrival stamp refreshed to *now*.

    Test/bench helper for emulated worlds: an in-process "rank" that sleeps
    before calling this genuinely arrives late at the barrier — the planted
    straggler is a measured fact, not a forged number.
    """
    row = np.array(meta_row, dtype=np.int32, copy=True)
    row[-1] = np.int32(_profile.epoch_now_us() & _MASK)
    return row


def _wrap_diff(a: int, b: int) -> int:
    """``a - b`` on the masked µs clock, corrected for one int32 wrap."""
    d = int(a) - int(b)
    if d > _HALF:
        d -= _MASK + 1
    elif d < -_HALF:
        d += _MASK + 1
    return d


def resolve_arrivals(
    prev_post: Sequence[int], arrivals: Sequence[int], local_rank: int
) -> Dict[str, Any]:
    """Offset-correct the gathered barrier stamps and attribute the straggler.

    Returns::

        {
          "offsets_us":   per-rank clock offset vs the local clock (0s when
                          uncalibrated — some rank has no prev_post yet),
          "calibrated":   whether offsets came from a real prior barrier,
          "arrivals_us":  the raw gathered arrival stamps,
          "corrected_us": arrivals minus offsets (one clock),
          "skew_us":      last corrected arrival - first,
          "last_rank":    rank index of the last (straggling) arrival,
        }
    """
    prev = [int(x) for x in prev_post]
    arr = [int(x) for x in arrivals]
    world = len(arr)
    local_rank = int(local_rank) if 0 <= int(local_rank) < world else 0
    calibrated = all(p != 0 for p in prev)
    if calibrated:
        offsets = [_wrap_diff(p, prev[local_rank]) for p in prev]
    else:
        offsets = [0] * world
    corrected = [_wrap_diff(a, 0) - o for a, o in zip(arr, offsets)]
    last_rank = max(range(world), key=lambda r: (corrected[r], r))
    skew = max(corrected) - min(corrected)
    return {
        "offsets_us": offsets,
        "calibrated": calibrated,
        "arrivals_us": arr,
        "corrected_us": corrected,
        "skew_us": int(skew),
        "last_rank": int(last_rank),
    }


# ------------------------------------------------------------------ merge

# event kinds rendered as duration slices when they carry a measured span.
# update.scan and async.drain spans make the overlap VISIBLE: a drain slice on
# the worker's track running alongside the caller track's enqueue instants is
# the attributed overlap_us, drawn
_SPAN_KINDS = frozenset(
    {
        "update.dispatch", "fused.dispatch", "compute.dispatch",
        "collection.step", "sync.exchange", "update.scan", "async.drain",
    }
)


def _event_fields(ev: Any) -> Dict[str, Any]:
    """Normalize one event (TraceEvent or export_json-shaped dict)."""
    if isinstance(ev, dict):
        ts_us = float(ev.get("ts_us", float(ev.get("ts", 0.0)) * 1e6))
        data = {
            k: v for k, v in ev.items() if k not in ("seq", "ts", "ts_us", "kind", "owner")
        }
        return {"seq": int(ev.get("seq", 0)), "ts_us": ts_us, "kind": str(ev.get("kind", "")),
                "owner": str(ev.get("owner", "")), "data": data}
    return {"seq": ev.seq, "ts_us": ev.ts * 1e6, "kind": ev.kind, "owner": ev.owner, "data": dict(ev.data)}


def merge_timelines(
    streams: Sequence[Dict[str, Any]], path: Optional[str] = None
) -> Dict[str, Any]:
    """Merge per-rank event streams into one Perfetto-loadable chrome trace.

    Args:
        streams: one dict per rank: ``{"rank": int, "events": [...],``
            ``"clock_offset_us": float}`` — events are flight-recorder
            :class:`~torchmetrics_tpu_torch.diag.trace.TraceEvent` objects (a
            ``recorder.snapshot()``) or ``export_json``-shaped dicts;
            ``clock_offset_us`` (default 0) is subtracted from every event
            timestamp, putting all ranks on one clock (use the packed sync's
            ``offsets_us``, or 0 for single-host emulations). A stream may
            additionally carry ``"pod": str`` (fleet streams) — see
            below.
        path: optional file to additionally write the JSON to.

    Layout: one chrome *process* per rank (``pid = rank``, named
    ``rank <r>``), one thread track per event owner inside it (``collective``
    events get per-role tracks, same convention as ``export_chrome_trace``).
    When ANY stream carries a ``pod`` id, the whole merge switches to fleet
    layout: streams order canonically by ``(pod, rank)``, each gets its own
    process track (pids are dense indexes in that order — two pods' rank 0
    can no longer collide) named ``pod <p> · rank <r>``, so one Perfetto
    trace shows the entire fleet. Byte-stable under pod-id permutation: the
    canonical sort, not arrival order, fixes every pid.
    Events with a measured span render as complete ("X") slices ending at
    their (corrected) record timestamp. Output ordering is fully
    deterministic: identical inputs serialize byte-identically.
    """
    trace_events: List[Dict[str, Any]] = []
    flat: List[Any] = []  # (ts_us, pid, seq, tid, is_span, dur, kind, data)
    tids: Dict[Any, int] = {}

    fleet = any("pod" in s for s in streams)
    ordered = sorted(
        streams, key=lambda s: (str(s.get("pod", "")), int(s.get("rank", 0)))
    )
    for index, stream in enumerate(ordered):
        rank = int(stream.get("rank", 0))
        pod = str(stream.get("pod", ""))
        # legacy (rank-only) streams keep pid = rank; fleet streams need a
        # dense pid because rank values repeat across pods
        pid = index if fleet else rank
        name = f"pod {pod} · rank {rank}" if fleet else f"rank {rank}"
        offset = float(stream.get("clock_offset_us", 0.0))
        trace_events.append(
            {"ph": "M", "pid": pid, "name": "process_name", "args": {"name": name}}
        )
        for raw in stream.get("events", ()):
            ev = _event_fields(raw)
            if ev["kind"] == "collective":
                owner = "collective:" + str(ev["data"].get("label") or "?")
            else:
                owner = ev["owner"] or "<process>"
            tid = tids.setdefault((pid, owner), len(tids) + 1)
            ts = round(ev["ts_us"] - offset, 3)
            dur = float(ev["data"].get("dispatch_us", 0.0))
            flat.append((ts, pid, ev["seq"], tid, ev["kind"], dur, ev["data"]))

    flow_seen: Dict[Any, bool] = {}  # lineage span id -> emitted a start yet
    for ts, rank, seq, tid, kind, dur, data in sorted(flat, key=lambda x: (x[0], x[1], x[2])):
        entry: Dict[str, Any] = {
            "name": kind,
            "pid": rank,
            "tid": tid,
            "args": {k: (v if isinstance(v, (int, float, bool, str)) else str(v)) for k, v in sorted(data.items())},
        }
        if kind in _SPAN_KINDS and dur > 0.0:
            entry.update(ph="X", ts=round(ts - dur, 3), dur=round(dur, 3))
        else:
            entry.update(ph="i", ts=ts, s="t")
        trace_events.append(entry)
        span = data.get("lineage")
        if span is not None:
            # causal flow arrows (diag/lineage.py): every event stamped with
            # the same lineage span id chains enqueue → drain → join → observe
            # across thread AND process tracks — "s" opens the arrow at the
            # first occurrence in merged order, "f"/bp="e" binds each later
            # occurrence, so Perfetto draws the value's whole causal path
            flow: Dict[str, Any] = {
                "name": "lineage", "cat": "lineage", "id": int(span),
                "pid": rank, "tid": tid, "ts": entry["ts"],
            }
            if flow_seen.setdefault(span, False):
                flow.update(ph="f", bp="e")
            else:
                flow_seen[span] = True
                flow["ph"] = "s"
            trace_events.append(flow)

    for (pid, owner), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        trace_events.append(
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name", "args": {"name": owner}}
        )

    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(trace, fh, sort_keys=True)
    return trace
