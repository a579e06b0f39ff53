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
"""

from __future__ import annotations

import os
from collections import Counter, deque
from contextlib import contextmanager
from contextvars import ContextVar
from time import perf_counter
from typing import Any, Dict, Generator, List, NamedTuple, Optional, Sequence

__all__ = [
    "FlightRecorder",
    "TraceEvent",
    "active_recorder",
    "attribute_retrace",
    "clear_recorder",
    "diag_context",
    "record",
]

DEFAULT_CAPACITY = 2048

#: env knob: "1" = on (default capacity), int > 1 = capacity, "0"/unset = off
TRACE_ENV_VAR = "TORCHMETRICS_TPU_TRACE"


class TraceEvent(NamedTuple):
    """One recorded event. ``ts`` is seconds since the recorder's epoch."""

    seq: int
    ts: float
    kind: str
    owner: str
    data: Dict[str, Any]


class FlightRecorder:
    """Bounded ring buffer of :class:`TraceEvent` with exact per-kind counts."""

    __slots__ = ("capacity", "events", "counts", "dropped", "t0", "_seq")

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = int(capacity)
        self.events: "deque[TraceEvent]" = deque(maxlen=self.capacity)
        self.counts: Counter = Counter()
        self.dropped = 0
        self.t0 = perf_counter()
        self._seq = 0

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

    def count(self, *kinds: str) -> int:
        """Total recorded events of the given kinds (drop-proof)."""
        return sum(self.counts.get(k, 0) for k in kinds)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FlightRecorder(events={len(self.events)}, kinds={dict(self.counts)}, dropped={self.dropped})"


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
    """The recorder events go to right now, or None when recording is off."""
    rec = _RECORDER_VAR.get()
    if rec is not None:
        return rec
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
