"""The program's own spans, read back and aligned to the profiler's trace: the helper of
the ``program_span`` readers (not a metric itself).

While the torch profiler records, the port keeps a span at each layer boundary of its
calls (``torchmetrics_tpu_torch/diag/trace.py``: ``api.update``, ``engine.stage``,
``eager.update``, ...) in its process recorder, timed by ``time.perf_counter_ns``. The
recorder empties its store when a call under the profiler follows one without it (the
warm-up runs unprofiled), so the store holds this window's spans alone. Their roots are
paired in order with the benchmark's call spans (``tr.trace.annotations`` of kind
``update``, ``forward``, ``compute`` and ``reset``): each call of a kind takes the same
number of roots of its ``api.*`` name (two ``api.update`` per ``update`` in the
vocabulary cell; a kind that opens no root, as a metric's own ``reset``, is left out). The trace has its own clock, whose rate may differ from
the host's by some ppm (a 2 s window at 28 ppm is 56 µs). Host time is mapped onto the
trace's by the line that leaves every call's roots the most room inside it on both sides:
the slope searched within ``SLOPE_PPM`` of 1, the offset the centre of the band the calls
allow. (A least-squares line through the pairs read -7 to -35 ppm on vocabulary runs of
an H100 host, from trends in the host's own delays, and left less room than slope 1.)

``aligned(tr)`` is None when the program keeps no spans (a version without them), the
span store dropped any, the roots do not pair with the calls, or a root lies outside its
call by more than ``TOLERANCE_US`` once mapped.
"""

from __future__ import annotations

import statistics
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

CALL_KINDS = ("update", "forward", "compute")
PAIRED_KINDS = CALL_KINDS + ("reset",)  # the benchmark's spans that call into the program
TOLERANCE_US = 50.0
SLOPE_PPM = 100.0  # the widest rate mismatch searched between the host's clock and the trace's

# the last run aligned, by a weak reference (its data is freed with it), and its alignment
_last: Tuple[Any, Any] = (None, None)


@dataclass
class Aligned:
    """The program spans of a traced window, on the trace's clock."""

    x0: float  # µs by the host clock (perf_counter_ns / 1e3) ...
    y0: float  # ... that maps to this µs of the trace's clock
    slope: float  # trace µs per host µs
    calls: List[Tuple[float, float, str]]  # the benchmark's call spans, in order
    roots: List[List[Any]]  # per call, the program root spans it made
    under: Dict[int, List[Any]]  # root id -> every span of that root
    intervals: List[Tuple[float, float]]  # every root span of the window, mapped

    def at(self, t_ns: float) -> float:
        """The trace time (µs) of a ``perf_counter_ns`` reading."""
        return self.y0 + self.slope * (t_ns / 1e3 - self.x0)

    def per_call(self, kinds: Tuple[str, ...], names: Tuple[str, ...], scale: float) -> List[float]:
        """For each call of ``kinds``, the summed durations of its spans named ``names``
        (roots and their descendants alike), times ``scale`` per ns."""
        out = []
        for (_, _, kind), roots in zip(self.calls, self.roots):
            if kind in kinds:
                out.append(scale * sum(s.t1 - s.t0 for r in roots for s in self.under[r.id] if s.name in names))
        return out


def _recorder():
    try:
        from torchmetrics_tpu_torch.diag import trace as program_trace
    except ImportError:
        return None
    get = getattr(program_trace, "process_recorder", None)
    return get() if get is not None else None


def _pair(calls, roots) -> Optional[Tuple[List[Tuple[float, float, str]], List[List[Any]]]]:
    """The calls that made roots, and the roots cut in order into one group per call;
    None when they do not fit."""
    per_call: Dict[str, int] = {}
    for kind in {c[2] for c in calls}:
        n_calls = sum(c[2] == kind for c in calls)
        n_roots = sum(r.name == "api." + kind for r in roots)
        if n_roots % n_calls or (not n_roots and kind in CALL_KINDS):
            return None
        per_call[kind] = n_roots // n_calls
    calls = [c for c in calls if per_call[c[2]]]
    if not calls or sum(per_call[c[2]] for c in calls) != len(roots):
        return None  # a root of a kind no benchmark span makes
    groups, i = [], 0
    for c in calls:
        group = roots[i:i + per_call[c[2]]]
        if any(r.name != "api." + c[2] for r in group):
            return None
        groups.append(group)
        i += len(group)
    return calls, groups


def _fit(calls, groups) -> Tuple[float, float, float]:
    """(x0, y0, slope) of the map ``y0 + slope * (t_us - x0)`` that leaves every call's
    roots the most room inside it on both sides. For a slope the best offset is the
    centre of the band the calls allow, and that band's width is concave in the slope
    (the least of lines less the greatest of lines), so a golden-section search finds
    the best slope within ``SLOPE_PPM``."""
    ends = [(min(r.t0 for r in g) / 1e3, max(r.t1 for r in g) / 1e3) for g in groups]
    x0 = statistics.fmean(a for a, _ in ends)
    ends = [(a - x0, b - x0) for a, b in ends]

    def band(slope):
        return (max(c[0] - slope * a for c, (a, _) in zip(calls, ends)),
                min(c[1] - slope * b for c, (_, b) in zip(calls, ends)))

    def width(slope):
        lo, hi = band(slope)
        return hi - lo

    golden = (5 ** 0.5 - 1) / 2
    a, b = 1 - SLOPE_PPM * 1e-6, 1 + SLOPE_PPM * 1e-6
    c, d = b - golden * (b - a), a + golden * (b - a)
    wc, wd = width(c), width(d)
    for _ in range(60):
        if wc >= wd:
            b, d, wd = d, c, wc
            c = b - golden * (b - a)
            wc = width(c)
        else:
            a, c, wc = c, d, wd
            d = a + golden * (b - a)
            wd = width(d)
    slope = (a + b) / 2
    lo, hi = band(slope)
    return x0, (lo + hi) / 2, slope


def _align(tr) -> Optional[Aligned]:
    rec = _recorder()
    if tr.trace is None or rec is None or getattr(rec, "spans_dropped", 1):
        return None
    spans = list(rec.spans)
    calls = sorted(a for a in tr.trace.annotations if a[2] in PAIRED_KINDS)
    roots = sorted((s for s in spans if s.parent == 0 and s.name.startswith("api.")), key=lambda s: s.t0)
    if not calls or not roots:
        return None
    paired = _pair(calls, roots)
    if paired is None:
        return None
    calls, groups = paired
    a = Aligned(*_fit(calls, groups), calls, groups, {}, [])
    for (c0, c1, _), group in zip(calls, groups):
        for r in group:
            t0, t1 = a.at(r.t0), a.at(r.t1)
            if t0 < c0 - TOLERANCE_US or t1 > c1 + TOLERANCE_US:
                return None
            a.intervals.append((t0, t1))
            a.under[r.id] = []
    for s in spans:
        if s.root in a.under:
            a.under[s.root].append(s)
    return a


def aligned(tr) -> Optional[Aligned]:
    """The window's program spans on the trace's clock (computed once per run)."""
    global _last
    if _last[0] is None or _last[0]() is not tr:
        _last = (weakref.ref(tr), _align(tr))
    return _last[1]


def median_per_call(tr, kinds: Tuple[str, ...], names: Tuple[str, ...], scale: float) -> Optional[float]:
    """The median over the window's calls of ``kinds`` of their summed ``names`` spans."""
    a = aligned(tr)
    if a is None:
        return None
    values = a.per_call(kinds, names, scale)
    return statistics.median(values) if values else None
