"""Flight recorder: a contextvar-scoped ring buffer of structured events.

Counterpart of ``torchmetrics_tpu/diag/trace.py``, copied (the module imports neither
JAX nor numpy), with the same names and environment variable; every kind the port
records is one of the JAX ``EVENT_KINDS`` (the tests hold them to that list). The
engines record ``update.*`` (trace / retrace / dispatch / probe / eager / quarantine /
ladder), ``fused.*``, ``update.scan*`` and ``scan.flush``, ``async.*``,
``collection.step``, ``compute.*``, ``sync.exchange`` / ``eager`` / ``noop`` /
``audit`` / ``straggler``, ``numerics.*``, ``lineage.*``, ``fallback``,
``transfer.host`` / ``transfer.blocked`` and ``heavy.fallback``. The sharding layer
(``parallel/sharding.py``) records ``shard.place`` / ``shard.fallback`` /
``shard.reshard`` / ``multihost.init``, the packed sync ``sync.shard_skip`` /
``sync.ingraph``, and the spec registry ``spec.fallback``. The fault-tolerance layer
records:

=====================  ========================================================
``sync.retry``         a bounded collective retried after a retryable fault
``sync.fault``         a collective fault that exhausted its retries or is not
                       retryable (``error``, ``rank``, ``attempts``)
``sync.degraded``      a packed sync re-planned over the surviving ranks
                       (``rank`` = the excluded culprit, ``survivors``)
``collective``         one packed-backbone gather (``label``, ``bytes``)
``snapshot.save``      one elastic shard written (``path``, ``rank``, ``world``)
``snapshot.restore``   one shard set restored into a world
``snapshot.fallback``  a corrupt or version-mismatched snapshot skipped
``snapshot.flush``     one continuous snapshot sequence written (``reason``)
``snapshot.preempt``   the signal-time flush (``skipped="mid-update"`` when the
                       signal landed inside an update)
``snapshot.restore_latest``  the sequence ``restore_latest`` restored
=====================  ========================================================

The signature manifest (``engine/persist.py``) records ``persist.manifest`` (a row
appended), ``persist.prewarm`` (one report per ``prewarm``) and ``persist.fallback`` (a
rejected artifact, a corrupt manifest line, a failed replay); ``persist.save`` and
``persist.load`` are the JAX kinds of a stored and a loaded executable, which a CUDA
graph never is.

Enablement (first hit wins): an active ``diag_context`` scope, else the
``TORCHMETRICS_TPU_TRACE`` environment variable (``"1"`` enables a process-global
recorder of the default capacity, an integer > 1 sets the capacity, ``"0"`` or unset
disables). ``record`` costs one ``ContextVar.get`` plus one environment read when
recording is off; events land in a ``deque(maxlen=capacity)`` whose per-kind counts
stay exact when old events drop.

``attribute_retrace`` names the cause of a rebuild by diffing signature fingerprints
(``engine/compiled.signature_fingerprint``); a cause other than ``initial`` is counted in
``EngineStats.retrace_causes``.

**Spans.** Beside its events a recorder keeps spans (``rec.spans``, a bounded store with
its own drop count ``spans_dropped``): a :class:`Span` has an id, the id of the span
around it (``parent``, 0 for none), the id of the outermost span of its call (``root``),
a name, an owner, ``t0`` / ``t1`` in ``time.perf_counter_ns()`` and a few attributes.
``rec.span(name, owner, **attrs)`` opens one; :func:`self_time` is a span's duration less
the part its children cover. The port's hot path opens them at each layer boundary:

=====================  ========================================================
``api.update`` /       the outermost call: ``MetricCollection.update`` /
``api.forward`` /      ``forward`` / ``compute`` / ``reset``; a metric's own
``api.compute`` /      ``update``, ``forward`` and ``compute`` when called on
``api.reset``          their own (inside another call they open none)
``collection.fused``   the collection's fused step (``collections.py``)
``collection.views``   the views re-anchored after a step
``engine.key``         eligibility, bucket and signature key (``engine/compiled.py``)
``engine.stage``       the states shielded and copied in, the batch copied in
``engine.replay``      one graph replay (``scope``: its ``tm:`` name)
``engine.bind``        the states bound to the buffers, the riders counted
``engine.build``       a signature's guarded warm-up and capture (update or compute)
``eager.update``       one metric's eager update (``reason``: why it fell back)
``epoch.drain``        the scan queues drained before a collection's compute
``epoch.sync``         a packed sync (``engine/epoch.py``)
``epoch.compute``      one metric's compute (``graph``: through its captured graph)
=====================  ========================================================

Whether a call records spans is resolved once, when its outermost span opens
(:func:`call`), and holds for everything under it: spans go to the active flight
recorder; else, while the torch profiler records, to :func:`process_recorder` (emptied
when a call under the profiler follows one without it); else, while a profile samples
(``diag/profile.py``), they are timed for its histograms and kept nowhere; else they are
off, and a span site costs one flag read. Under a call, :func:`active_recorder` and
``profile.active_profile`` (through :func:`env_profile`) answer from that resolution
and read no environment variable; a change to either variable applies from the next
call. The ``dispatch_us`` of ``collection.step``, ``update.dispatch``,
``fused.dispatch`` and ``update.eager`` are the durations of these spans.

Reading them::

    with diag_context() as rec:             # or TORCHMETRICS_TPU_TRACE=1, process-wide
        mc.update(preds, target)
    spans = rec.spans                       # a copy, oldest closed first
    for sp in spans:
        print(sp.name, sp.owner, sp.duration_us, self_time(sp, spans) / 1e3, sp.attrs)
    export_chrome_trace("trace.json", rec)  # nested complete slices, a track per owner

Under ``torch.profiler`` their clock is not the trace's: pair a span of your own around
each call (a ``record_function``) with the ``api.*`` roots inside it, in order, and fit
the map between the clocks on the pairs (``cudabench/layer_metrics/_program_spans.py``).
"""

from __future__ import annotations

import itertools
import os
import threading
from collections import Counter, deque
from contextlib import contextmanager
from contextvars import ContextVar
from time import perf_counter, perf_counter_ns
from typing import Any, Dict, Generator, Iterable, List, NamedTuple, Optional, Sequence

import torch.autograd.profiler as _torch_profiler

from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import profile as _profile

__all__ = [
    "FlightRecorder",
    "Span",
    "TraceEvent",
    "active_recorder",
    "attribute_retrace",
    "call",
    "clear_recorder",
    "diag_context",
    "process_recorder",
    "record",
    "self_time",
    "span",
]

DEFAULT_CAPACITY = 2048
DEFAULT_SPAN_CAPACITY = 16384
#: the span store of the recorder that takes spans while only the torch profiler records
PROCESS_SPAN_CAPACITY = 65536

#: env knob: "1" = on (default capacity), int > 1 = capacity, "0"/unset = off
TRACE_ENV_VAR = "TORCHMETRICS_TPU_TRACE"


class TraceEvent(NamedTuple):
    """One recorded event. ``ts`` is seconds since the recorder's epoch."""

    seq: int
    ts: float
    kind: str
    owner: str
    data: Dict[str, Any]


_ROW = ("id", "parent", "root", "name", "owner", "t0", "t1", "attrs")


class Span:
    """One timed stretch of a call; its own context manager. Entered, it takes its
    parent and root from the innermost open span of this thread; left, it lands in
    its recorder's span store as a plain tuple of :data:`_ROW` (a tuple of numbers and
    strings leaves the garbage collector's lists, so a full store adds no collections)."""

    __slots__ = (*_ROW, "_rec", "_prev")

    def __init__(self, rec: "FlightRecorder", name: str, owner: str, attrs: Optional[Dict[str, Any]]) -> None:
        self._rec = rec
        self.name = name
        self.owner = owner
        self.attrs = attrs

    def __enter__(self) -> "Span":
        c = _CALL
        outer = self._prev = c.open
        self.id = sid = next(self._rec._span_ids)
        if outer is None:
            self.parent, self.root = 0, sid
        else:
            self.parent, self.root = outer.id, outer.root
        c.open = self
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        self.t1 = t1 = perf_counter_ns()
        _CALL.open = self._prev
        rec = self._rec
        rows = rec._span_rows
        if len(rows) == rec.span_capacity:
            rec.spans_dropped += 1
        rows.append((self.id, self.parent, self.root, self.name, self.owner, self.t0, t1, self.attrs))
        return False

    @classmethod
    def _of(cls, row: tuple) -> "Span":
        sp = cls.__new__(cls)
        for name, value in zip(_ROW, row):
            setattr(sp, name, value)
        return sp

    @property
    def duration_us(self) -> float:
        return round((self.t1 - self.t0) / 1e3, 3)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.owner!r}, id={self.id}, parent={self.parent}, root={self.root})"


class FlightRecorder:
    """Bounded ring buffer of :class:`TraceEvent` with exact per-kind counts, and a
    bounded store of :class:`Span` beside it."""

    __slots__ = (
        "capacity", "events", "counts", "dropped", "t0", "_seq",
        "span_capacity", "_span_rows", "spans_dropped", "_span_ids",
    )

    def __init__(self, capacity: int = DEFAULT_CAPACITY, span_capacity: int = DEFAULT_SPAN_CAPACITY) -> None:
        self.capacity = int(capacity)
        self.events: "deque[TraceEvent]" = deque(maxlen=self.capacity)
        self.counts: Counter = Counter()
        self.dropped = 0
        self.t0 = perf_counter()
        self._seq = 0
        self.span_capacity = int(span_capacity)
        self._span_rows: "deque[tuple]" = deque(maxlen=self.span_capacity)
        self.spans_dropped = 0
        self._span_ids = itertools.count(1)

    def span(self, name: str, owner: str = "", **attrs: Any) -> Span:
        """A span to enter (``with rec.span(...) as sp``), nested in the open one."""
        return Span(self, name, owner, attrs or None)

    @property
    def spans(self) -> List[Span]:
        """The stored spans, oldest closed first."""
        return [Span._of(row) for row in self._span_rows]


    def record(self, kind: str, owner: str = "", **data: Any) -> None:
        """Append one event; O(1), never raises for capacity reasons."""
        if len(self.events) == self.capacity:
            self.dropped += 1
        self._seq += 1
        self.counts[kind] += 1
        self.events.append(TraceEvent(self._seq, perf_counter() - self.t0, kind, owner, data))

    def snapshot(self) -> List[TraceEvent]:
        """Stable copy of the buffered events (oldest first)."""
        return list(self.events)

    def clear(self) -> None:
        self.events.clear()
        self.counts.clear()
        self.dropped = 0
        self._seq = 0
        self.t0 = perf_counter()
        self._span_rows.clear()
        self.spans_dropped = 0

    def count(self, *kinds: str) -> int:
        """Total recorded events of the given kinds (drop-proof)."""
        return sum(self.counts.get(k, 0) for k in kinds)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (
            f"FlightRecorder(events={len(self.events)}, kinds={dict(self.counts)}, dropped={self.dropped},"
            f" spans={len(self._span_rows)}, spans_dropped={self.spans_dropped})"
        )


_RECORDER_VAR: "ContextVar[Optional[FlightRecorder]]" = ContextVar("tm_tpu_diag_recorder", default=None)

# process-global recorder backing TORCHMETRICS_TPU_TRACE; (env_value, recorder)
# cached so a steady env var costs one os.environ read + string compare per call
_env_state: tuple = ("", None)


def _env_recorder() -> Optional[FlightRecorder]:
    global _env_state
    raw = os.environ.get(TRACE_ENV_VAR, "").strip()
    if raw == _env_state[0]:
        return _env_state[1]
    rec: Optional[FlightRecorder] = None
    if raw and raw != "0":
        try:
            cap = int(raw)
        except ValueError:
            cap = DEFAULT_CAPACITY
        rec = FlightRecorder(cap if cap > 1 else DEFAULT_CAPACITY)
    _env_state = (raw, rec)
    return rec


def active_recorder() -> Optional[FlightRecorder]:
    """The recorder events go to right now, or None when recording is off. Under a
    call the environment variable is the one read when the call began."""
    rec = _RECORDER_VAR.get()
    if rec is not None:
        return rec
    c = _CALL
    if c.depth:
        return c.env_rec
    return _env_recorder()


def record(kind: str, owner: str = "", **data: Any) -> None:
    """Record one event if recording is active; near-free otherwise."""
    rec = active_recorder()
    if rec is not None:
        rec.record(kind, owner, **data)


def clear_recorder() -> None:
    """Clear the active recorder's ring buffer (no-op when recording is off)."""
    rec = active_recorder()
    if rec is not None:
        rec.clear()


@contextmanager
def diag_context(
    capacity: int = DEFAULT_CAPACITY, recorder: Optional[FlightRecorder] = None
) -> Generator[FlightRecorder, None, None]:
    """Scoped recording: installs (and yields) a flight recorder.

    Nested scopes stack — events go to the innermost recorder only, and the
    outer scope resumes on exit. Pass an existing ``recorder`` to accumulate
    several scopes into one buffer.
    """
    rec = recorder if recorder is not None else FlightRecorder(capacity)
    token = _RECORDER_VAR.set(rec)
    try:
        yield rec
    finally:
        _RECORDER_VAR.reset(token)


# ------------------------------------------------------------------ spans


class _CallState(threading.local):
    """This thread's outermost call: whether it is open (``depth``), where its spans go
    (``sink``: ``_OFF`` when they are off, None outside a call), the environment as read
    when it began, whether a recorder or a profile observes it (``measuring``:
    histograms and dispatch events), and the innermost open span."""

    depth = 0
    sink: Any = None
    env_rec: Optional[FlightRecorder] = None
    env_profile: Optional[int] = None
    measuring = False
    open: Optional[Span] = None


_CALL = _CallState()
_OFF = object()  # the sink of a call whose spans are off
_process: Optional[FlightRecorder] = None
_profiled = False  # whether the last call resolved saw the torch profiler record
# spans timed for a profile's histograms and kept nowhere
_TIMED_ONLY = FlightRecorder(capacity=1, span_capacity=0)


def process_recorder() -> FlightRecorder:
    """The recorder that takes spans while the torch profiler records and no flight
    recorder is active (events never go to it). A call the profiler records right after
    one it did not empties it first, so it holds one profiling session's spans."""
    global _process
    if _process is None:
        _process = FlightRecorder(capacity=1, span_capacity=PROCESS_SPAN_CAPACITY)
    return _process


def _resolve() -> Optional[FlightRecorder]:
    """Where spans go now (None: off), and whether a recorder or a profile observes."""
    global _profiled
    c = _CALL
    rec = _RECORDER_VAR.get()
    if rec is None:
        rec = c.env_rec if c.depth else _env_recorder()
    profiling = _profile.active_profile() is not None
    if c.depth:
        c.measuring = rec is not None or profiling
    if rec is not None:
        return rec
    if not _torch_profiler._is_profiler_enabled:
        _profiled = False
        return _TIMED_ONLY if profiling else None
    proc = process_recorder()
    if not _profiled:
        _profiled = True
        proc.clear()
    return proc


class _OffCall:
    """The outermost call with spans off: it only closes the call's state."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        _end_call()
        return False


class _RootSpan(Span):
    __slots__ = ()

    def __exit__(self, *exc: Any) -> bool:
        super().__exit__(*exc)
        _end_call()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_OFF_CALL = _OffCall()
_NO_SPAN = _NoSpan()


def _end_call() -> None:
    c = _CALL
    c.depth = 0
    c.sink = c.env_rec = c.env_profile = None
    c.measuring = False


def call(name: str, owner: str = "", child: bool = True) -> Any:
    """The ``api.*`` span of a call into the port. Outermost, it resolves once where
    this call's spans go (reading each environment variable once) and yields its root
    span (None when spans are off). Inside another call it is a child span, or with
    ``child=False`` nothing at all."""
    c = _CALL
    if c.depth:
        return span(name, owner) if child else _NO_SPAN
    c.depth = 1
    c.env_rec = _env_recorder()
    c.env_profile = _profile._env_profile()
    sink = _resolve()
    if sink is None:
        c.sink = _OFF
        return _OFF_CALL
    c.sink = sink
    return _RootSpan(sink, name, owner, None)


def span(name: str, owner: str = "", attrs: Optional[Dict[str, Any]] = None) -> Any:
    """A span site: the span to enter, or a shared no-op when spans are off (one flag
    read under a call). Outside any call it resolves for itself."""
    sink = _CALL.sink
    if sink is _OFF:
        return _NO_SPAN
    if sink is None:
        sink = _resolve()
        if sink is None:
            return _NO_SPAN
    return Span(sink, name, owner, attrs)


def measuring() -> bool:
    """Whether a flight recorder or a profile observes: the histograms and dispatch
    events are fed (always with spans on)."""
    c = _CALL
    if c.depth:
        return c.measuring
    return active_recorder() is not None or _profile.active_profile() is not None


def env_profile() -> Optional[int]:
    """``TORCHMETRICS_TPU_PROFILE``'s sampling rate: under a call as read when the call
    began, else read now (``diag/profile.active_profile`` asks this)."""
    c = _CALL
    return c.env_profile if c.depth else _profile._env_profile()


def observe_dispatch(
    start: Optional[Span], owner: str, hist_kind: str, event: str, end: Optional[Span] = None, **fields: Any
) -> Optional[float]:
    """While something observes, feed ``hist_kind``'s ``dispatch_us`` histogram and the
    ``event`` with the time from ``start``'s start to ``end``'s end (``start``'s own by
    default), and return it; None when nothing observes."""
    if start is None or not measuring():
        return None
    dispatch_us = round(((end or start).t1 - start.t0) / 1e3, 3)
    _hist.observe(owner, hist_kind, "dispatch_us", dispatch_us)
    rec = active_recorder()
    if rec is not None:
        rec.record(event, owner, dispatch_us=dispatch_us, **fields)
    return dispatch_us


def self_time(sp: Span, spans: Iterable[Span]) -> int:
    """``sp``'s duration less the part of it that its children cover, in ns."""
    covered = sorted((max(s.t0, sp.t0), min(s.t1, sp.t1)) for s in spans if s.parent == sp.id)
    busy, end = 0, sp.t0
    for a, b in covered:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return (sp.t1 - sp.t0) - busy


# ------------------------------------------------------------------ retrace cause

# field -> cause, in attribution priority order: a structural (treedef) change
# outranks a dtype change outranks a bucket miss outranks a plain shape change —
# e.g. the x64 warmup promotes state dtypes AND (bucketed) shapes; the dtype is
# the actionable cause.
_CAUSE_BY_FIELD = (
    ("treedef", "treedef-change"),
    ("dtype", "dtype-change"),
    ("bucket", "bucket-miss"),
    ("shape", "shape-change"),
    ("plan", "plan-change"),
    ("device", "device-change"),
)


def attribute_retrace(new: Dict[str, Any], previous: Sequence[Dict[str, Any]]) -> str:
    """Attribute a re-compile by diffing ``new`` against prior fingerprints.

    ``new``/``previous`` are signature *fingerprints*: small dicts with any of
    the keys ``treedef`` / ``dtype`` / ``bucket`` / ``shape`` / ``plan`` /
    ``device`` holding hashable summaries of the respective signature aspect.
    Returns ``"initial"`` for the first compile ever, else the
    highest-priority field that differs from the NEAREST previous fingerprint
    (fewest differing fields) — the minimal change that forced the retrace.
    """
    if not previous:
        return "initial"
    best_diff: Optional[List[str]] = None
    for old in previous:
        diff = [k for k, _ in _CAUSE_BY_FIELD if new.get(k) != old.get(k)]
        if best_diff is None or len(diff) < len(best_diff):
            best_diff = diff
            if not diff:
                break
    if not best_diff:
        # identical fingerprint yet a new cache entry: something outside the
        # fingerprinted aspects changed (should not happen — surfaced, not hidden)
        return "unknown"
    causes = dict(_CAUSE_BY_FIELD)
    for field, _ in _CAUSE_BY_FIELD:
        if field in best_diff:
            return causes[field]
    return "unknown"
