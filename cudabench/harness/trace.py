"""Spans around the calls into the program, and the profiler's trace read back.

A traced run wraps every call the window makes into the program (``update`` or
``forward``, ``compute``, the read to the host, ``reset``, the batch slice) in a span:
a ``torch.profiler.record_function`` named ``cudabench.<kind>`` and the host clock
around it. The profiler's Chrome trace then gives every operation that ran on the
device, and its correlation id ties it to the runtime call that launched it, and so to
the span the host was in. Busy time is the union of the device intervals, never their
sum.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "cudabench."
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
RUNTIME_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})
NAME_WIDTH = 80  # device operation names are cut to this many characters
TOP = 10  # entries in each list of the breakdown
_OFF = nullcontext()


@dataclass
class HostSpan:
    kind: str
    index: int  # the n-th span of its kind
    host_s: float  # its length by the host clock
    meta: dict


class Recorder:
    """Spans of one run. Off (``traced=False``) it records nothing and costs a branch."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.spans: List[HostSpan] = []
        self._counts: Dict[str, int] = {}
        self._record_function = None
        if traced:
            from torch.profiler import record_function

            self._record_function = record_function

    def span(self, kind: str, **meta):
        """A context around one call into the program (a shared no-op when off)."""
        return self._span(kind, meta) if self.traced else _OFF

    @contextmanager
    def _span(self, kind: str, meta: dict):
        index = self._counts.get(kind, 0)
        self._counts[kind] = index + 1
        with self._record_function(SPAN_PREFIX + kind):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append(HostSpan(kind, index, time.perf_counter() - t0, meta))

    def of_kind(self, *kinds: str) -> List[HostSpan]:
        return [s for s in self.spans if s.kind in kinds]


@dataclass
class DeviceOp:
    t0: float  # µs, the trace's clock
    t1: float
    name: str
    span: Optional[Tuple[str, int]]  # (kind, index) of the span that launched it


@dataclass
class Trace:
    """What the profiler saw over the traced window."""

    ops: List[DeviceOp]
    annotations: List[Tuple[float, float, str]]  # (t0, t1, kind) in the trace's clock
    window: Tuple[float, float]
    busy_us: float = 0.0
    gaps: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def union_us(self, ops: List[DeviceOp]) -> float:
        return sum(b - a for a, b in merge([(o.t0, o.t1) for o in ops]))

    def host_kind_at(self, t: float) -> str:
        """The span the host was in at trace time ``t`` (``outside`` if none)."""
        starts = [a[0] for a in self.annotations]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            a0, a1, kind = self.annotations[i]
            if a0 <= t <= a1:
                return kind
            if a1 < t:
                break
            i -= 1
        return "outside"

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + (op.t1 - op.t0) * 1e-6
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:TOP]
        idle = [[self.host_kind_at((a + b) / 2), (b - a) * 1e-6] for a, b in longest]
        return {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": idle}


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse(events: List[dict]) -> Trace:
    """A ``Trace`` from Chrome trace events: the device operations, each tied to the
    span whose runtime call launched it, clipped to the window the spans cover."""
    launches: Dict[int, float] = {}
    annotations = []
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat == "user_annotation" and ev.get("name", "").startswith(SPAN_PREFIX):
            annotations.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"][len(SPAN_PREFIX):]))
        elif cat in RUNTIME_CATEGORIES:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat in DEVICE_CATEGORIES:
            device.append(ev)
    annotations.sort()
    if not annotations:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    window = (annotations[0][0], max(a[1] for a in annotations))
    counts: Dict[str, int] = {}
    numbered = []
    for a0, a1, kind in annotations:
        numbered.append((a0, a1, kind, counts.get(kind, 0)))
        counts[kind] = counts.get(kind, 0) + 1
    starts = [a[0] for a in numbered]

    def launcher(t: float) -> Optional[Tuple[str, int]]:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and numbered[i][0] <= t <= numbered[i][1]:
            return numbered[i][2], numbered[i][3]
        return None

    ops = []
    for ev in device:
        t0 = float(ev["ts"])
        t1 = t0 + float(ev.get("dur", 0.0))
        t0, t1 = max(t0, window[0]), min(t1, window[1])
        if t1 <= t0:
            continue
        corr = ev.get("args", {}).get("correlation")
        launched = launches.get(corr)
        ops.append(DeviceOp(t0, t1, ev.get("name", "?")[:NAME_WIDTH], launcher(launched) if launched is not None else None))
    ops.sort(key=lambda o: o.t0)
    busy = merge([(o.t0, o.t1) for o in ops])
    edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return Trace(ops=ops, annotations=[(a, b, k) for a, b, k in annotations], window=window,
                 busy_us=sum(b - a for a, b in busy), gaps=gaps)


@contextmanager
def profiled(traced: bool, holder: dict):
    """Profile the block (CPU and CUDA activity) when ``traced``; ``holder["trace"]``
    then holds the parsed ``Trace``. The Chrome trace goes through a temporary file
    under ``TMPDIR`` that is deleted once read."""
    if not traced:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    import torch

    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            holder["trace"] = parse(json.load(fh)["traceEvents"])
    finally:
        os.remove(path)
