"""End-to-end value provenance & freshness plane (counterpart of
``torchmetrics_tpu/diag/lineage.py``; host-side only, it touches no tensor).

Every queued/async/federated layer the engine grew (scan queues, background
drains, quarantine, degraded sync, cross-pod folds) widened the gap between
"steps the training loop handed us" and "steps the value you are looking at
actually reflects" — and until now no observed value could state that gap.
This module closes it host-side, from counters the engine already keeps:

- **Watermarks** — a monotonic per-owner ledger of steps *enqueued* (handed to
  a scan queue), steps *folded* (applied by a drain, replay, or discard
  realignment), and steps *observed* (reflected by the last observation), plus
  per-reason exclusion counts (``quarantined``, ``replayed``, ``discarded``).
- **Staleness bound** — at observation time, ``steps_enqueued - steps_folded``
  is the exact steps-behind bound, and the profile-epoch clock
  (:func:`~torchmetrics_tpu_torch.diag.profile.epoch_now_us`) dates the oldest
  still-unfolded enqueue for a wall-µs-behind bound. Zero device reads: both
  numbers come from host counters, so the plane is STRICT-guard clean by
  construction.
- **Causal spans** — a lineage id opened at enqueue rides ``_DrainWork``
  through the drain/join/sync/compute events (a ``lineage`` data key on the
  existing kinds — no new event kinds for the hot path) and is rendered as
  Chrome-trace flow arrows by :func:`~torchmetrics_tpu_torch.diag.timeline.
  merge_timelines`; the :data:`LINEAGE_HEADER` header carries the stamp
  cross-pod on ``/state`` and ``/telemetry.bin`` envelopes.
- **Coverage attestation** — degraded-sync membership and federation/fleet
  pod coverage (members included, per-pod seqs, excluded ids with reasons)
  stamp the :class:`ValueProvenance` record, so a global value computed from
  3/4 pods says so.

Freshness feeds the ``staleness_steps`` / ``staleness_us`` histogram series
(``diag/hist.py``), which the JAX package's SLO engine reads; ``diag/slo.py`` and the
serving layer have no counterpart in the port yet.

The plane is passive and default-ON (``TORCHMETRICS_TPU_LINEAGE=0`` turns it
off); with it off every note/observe call is an early-return no-op, so
unsampled paths are byte-identical.
"""

from __future__ import annotations

import json
import os
import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.diag.profile import epoch_now_us


def _user_error(message: str) -> Exception:
    # lazy: ``utilities`` transitively initializes parallel/engine — importing
    # it at module level from a diag-package module re-enters the half-built
    # package when ``diag/__init__`` (or ``engine/scan``) pulls lineage in
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    return TorchMetricsUserError(message)

__all__ = [
    "LINEAGE_HEADER",
    "ValueProvenance",
    "decode_lineage_header",
    "encode_lineage_header",
    "lineage_context",
    "lineage_enabled",
    "lineage_snapshot",
    "note_coverage",
    "note_discarded",
    "note_enqueued",
    "note_excluded",
    "note_folded",
    "note_observed",
    "observe_all",
    "observe_metric",
    "open_span",
    "provenance_of",
    "reset_lineage",
    "settle_span",
    "stalest_owner",
    "take_span",
]

#: Cross-pod provenance stamp header on ``/state`` and ``/telemetry.bin``
#: envelopes (compact JSON; see :func:`encode_lineage_header`).
LINEAGE_HEADER = "X-TM-Lineage"

_LINEAGE_ENV_VAR = "TORCHMETRICS_TPU_LINEAGE"

#: Exclusion reasons the watermark ledger recognizes. Anything else at a
#: ``note_excluded`` call site is a programming error, surfaced loudly.
_EXCLUSION_REASONS = ("discarded", "quarantined", "replayed")


def lineage_enabled() -> bool:
    """The ONE recognized parser for ``TORCHMETRICS_TPU_LINEAGE`` (fail-loud).

    Unset / ``""`` / ``"1"`` / ``"on"`` = on (the default: provenance is
    passive and host-side, so there is no hot-loop cost to opt out of);
    ``"0"`` / ``"off"`` = off. Anything else fails loud — the env
    contract: a typo must not silently disable the evidence surface. A
    :func:`lineage_context` override wins over the environment.
    """
    if _enabled_override is not None:
        return _enabled_override
    raw = os.environ.get(_LINEAGE_ENV_VAR, "").strip().lower()
    if raw in ("", "1", "on"):
        return True
    if raw in ("0", "off"):
        return False
    raise _user_error(
        f"Invalid {_LINEAGE_ENV_VAR}={raw!r}: expected unset/'1'/'on' to"
        " enable value provenance or '0'/'off' to disable it."
    )


_enabled_override: Optional[bool] = None


@contextmanager
def lineage_context(enabled: bool = True) -> Generator:
    """Scoped enable/disable override (tests/bench — no environment mutation)."""
    global _enabled_override
    prev = _enabled_override
    _enabled_override = bool(enabled)
    try:
        yield
    finally:
        _enabled_override = prev


# ------------------------------------------------------------------ ledger

class _Watermark:
    """Mutable per-owner watermark row (guarded by the module lock)."""

    __slots__ = (
        "enqueued", "folded", "observed", "excluded",
        "pending_since_us", "open_span_id", "last_span_id",
    )

    def __init__(self) -> None:
        self.enqueued = 0
        self.folded = 0
        self.observed = 0
        self.excluded: Counter = Counter()
        # epoch-µs instant of the oldest enqueue not yet folded; None while
        # fully caught up. This dates the wall-staleness BOUND: the observed
        # value is at most (now - pending_since_us) behind the newest enqueue.
        self.pending_since_us: Optional[float] = None
        self.open_span_id: Optional[int] = None
        self.last_span_id: Optional[int] = None


_lock = threading.Lock()
_watermarks: Dict[str, _Watermark] = {}
_coverage: Dict[str, Dict[str, Any]] = {}  # owner -> last coverage stamp
_span_counter = 0

# lazy: engine.stats imports diag.trace at module import, so a module-level
# import here would re-enter a partially-initialized diag package
_stats_obj: Optional[Any] = None


def _stats():
    global _stats_obj
    if _stats_obj is None:
        from torchmetrics_tpu_torch.engine.stats import EngineStats

        _stats_obj = EngineStats("lineage")
    return _stats_obj


def _mark(owner: str) -> _Watermark:
    wm = _watermarks.get(owner)
    if wm is None:
        wm = _watermarks[owner] = _Watermark()
    return wm


@dataclass
class ValueProvenance:
    """What one observed value actually covers, and how stale it is.

    Attached to computed values (``metric._provenance``), to envelope headers
    (:data:`LINEAGE_HEADER`) and to the ``provenance`` section of
    :func:`~torchmetrics_tpu_torch.diag.report.diag_report`.
    """

    owner: str
    where: str  # observation site: "compute" | "snapshot" | "scrape" | ...
    steps_enqueued: int
    steps_folded: int
    steps_observed: int
    staleness_steps: int  # enqueued-but-unfolded steps the value excludes
    staleness_us: float  # wall-µs bound: age of the oldest unfolded enqueue
    excluded: Dict[str, int] = field(default_factory=dict)  # reason -> steps
    span: Optional[int] = None  # last settled causal span (flow-arrow id)
    coverage: Optional[Dict[str, Any]] = None  # sync/federation membership

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "owner": self.owner,
            "where": self.where,
            "steps_enqueued": self.steps_enqueued,
            "steps_folded": self.steps_folded,
            "steps_observed": self.steps_observed,
            "staleness_steps": self.staleness_steps,
            "staleness_us": self.staleness_us,
            # sorted: byte-stable JSON (header stamps must be deterministic)
            "excluded": {k: self.excluded[k] for k in sorted(self.excluded)},
        }
        if self.span is not None:
            out["span"] = self.span
        if self.coverage is not None:
            out["coverage"] = self.coverage
        return out


# ------------------------------------------------------------------ writes

def note_enqueued(owner: str, steps: int = 1, span: bool = True) -> None:
    """Advance the enqueue watermark: ``steps`` handed to a queue, not yet
    applied. Called under the scan queue's push lock — the module lock nests
    inside it (never the reverse; no lock-order cycle). ``span=True`` (the
    default) also opens the owner's causal span when none is open, so the
    single-metric enqueue path pays ONE lock acquisition; fused queues pass
    ``span=False`` per member and open one span on the queue owner instead."""
    if not lineage_enabled():
        return
    global _span_counter
    with _lock:
        wm = _mark(owner)
        if wm.pending_since_us is None:
            # going caught-up -> behind: this instant dates the wall bound
            wm.pending_since_us = epoch_now_us()
        if span and wm.open_span_id is None:
            _span_counter += 1
            wm.open_span_id = _span_counter
            _stats().lineage_spans += 1
        wm.enqueued += steps


def note_folded(owner: str, steps: int) -> None:
    """Advance the fold watermark: ``steps`` actually applied to state."""
    if not lineage_enabled():
        return
    with _lock:
        wm = _mark(owner)
        wm.folded += steps
        if wm.folded >= wm.enqueued:
            wm.pending_since_us = None  # caught up: no wall staleness


def note_excluded(owner: str, reason: str, steps: int) -> None:
    """Count ``steps`` the observed value does NOT cover, by reason."""
    if reason not in _EXCLUSION_REASONS:
        raise _user_error(
            f"Unknown lineage exclusion reason {reason!r}; expected one of"
            f" {_EXCLUSION_REASONS}."
        )
    if not lineage_enabled() or steps <= 0:
        return
    with _lock:
        _mark(owner).excluded[reason] += steps


def note_discarded(owner: str, steps: int) -> None:
    """Realign after ``discard()``: dropped steps will never fold, so they
    advance the fold watermark (they no longer make the value stale) AND
    count as a ``discarded`` exclusion (the value still doesn't cover them).
    """
    if not lineage_enabled() or steps <= 0:
        return
    with _lock:
        wm = _mark(owner)
        wm.folded += steps
        wm.excluded["discarded"] += steps
        if wm.folded >= wm.enqueued:
            wm.pending_since_us = None


# ------------------------------------------------------------------ spans

def open_span(owner: str) -> Optional[int]:
    """Open (or return the already-open) causal span for ``owner``.

    Called at the first enqueue of a drain generation; the id flows through
    ``_DrainWork`` to the drain/join events and the timeline's flow arrows.
    """
    if not lineage_enabled():
        return None
    global _span_counter
    with _lock:
        wm = _mark(owner)
        if wm.open_span_id is None:
            _span_counter += 1
            wm.open_span_id = _span_counter
            _stats().lineage_spans += 1
        return wm.open_span_id


def take_span(owner: str) -> Optional[int]:
    """Take the open span (queue swap: the generation is leaving the queue).

    The taken id is stamped on the in-flight work; the next enqueue opens a
    fresh span. Settles as ``last_span_id`` so observations can reference the
    most recent causal chain even after the work retired.
    """
    if not lineage_enabled():
        return None
    with _lock:
        wm = _mark(owner)
        span, wm.open_span_id = wm.open_span_id, None
        if span is not None:
            wm.last_span_id = span
        return span


def settle_span(owner: str, span: Optional[int]) -> None:
    """Record ``span`` as the owner's most recently completed causal chain."""
    if span is None or not lineage_enabled():
        return
    with _lock:
        _mark(owner).last_span_id = span


# ------------------------------------------------------------------ coverage

def note_coverage(
    owner: str,
    members: Sequence[Any],
    seqs: Optional[Dict[str, int]] = None,
    excluded: Sequence[Tuple[Any, str]] = (),
) -> Optional[Dict[str, Any]]:
    """Attest what a folded value covers: members in, members out, and why.

    Wired at the three fold sites — degraded packed sync (rank membership),
    federation fold (pod ids + snapshot seqs), fleet telemetry merge. The
    stamp is stored per owner (``provenance_of`` attaches it to later
    observations), recorded as a ``lineage.coverage`` event, and returned so
    fold sites can embed it in their own results.
    """
    if not lineage_enabled():
        return None
    stamp: Dict[str, Any] = {
        "members": [str(m) for m in members],
        "excluded": [{"id": str(pid), "reason": str(reason)} for pid, reason in excluded],
    }
    if seqs:
        stamp["seqs"] = {str(k): int(seqs[k]) for k in sorted(seqs)}
    stamp["complete"] = not stamp["excluded"]
    with _lock:
        _mark(owner)  # aggregation-tier owners fold without enqueuing; the
        # row makes their coverage visible in lineage_snapshot/provenance_of
        _coverage[owner] = stamp
        _stats().lineage_coverage_folds += 1
    _diag.record(
        "lineage.coverage",
        owner,
        members=",".join(stamp["members"]),
        excluded=",".join(f"{e['id']}:{e['reason']}" for e in stamp["excluded"]),
        complete=stamp["complete"],
    )
    return stamp


# ------------------------------------------------------------------ reads

def note_observed(
    owner: str,
    where: str,
    coverage: Optional[Dict[str, Any]] = None,
) -> Optional[ValueProvenance]:
    """Build the provenance record for one observation of ``owner``.

    Sets the observed watermark to the fold watermark (an observation reflects
    exactly what has folded), computes both staleness bounds host-side, feeds
    the freshness histograms/SLO, and records a ``lineage.observe`` event
    carrying the span id for timeline flow arrows.
    """
    if not lineage_enabled():
        return None
    with _lock:
        wm = _mark(owner)
        wm.observed = wm.folded
        behind = max(0, wm.enqueued - wm.folded)
        wall_us = 0.0
        if behind and wm.pending_since_us is not None:
            wall_us = max(0.0, epoch_now_us() - wm.pending_since_us)
        record = ValueProvenance(
            owner=owner,
            where=where,
            steps_enqueued=wm.enqueued,
            steps_folded=wm.folded,
            steps_observed=wm.observed,
            staleness_steps=behind,
            staleness_us=round(wall_us, 3),
            excluded=dict(wm.excluded),
            span=wm.last_span_id,
            coverage=coverage if coverage is not None else _coverage.get(owner),
        )
        _stats().lineage_records += 1
    # histograms feed the value-freshness SLO: unconditional like the sidecar
    # scrape-latency series (bounded by observation volume, not step volume)
    _hist.observe(owner, "lineage", "staleness_steps", float(behind))
    _hist.observe(owner, "lineage", "staleness_us", record.staleness_us)
    data: Dict[str, Any] = {
        "where": where,
        "enqueued": record.steps_enqueued,
        "folded": record.steps_folded,
        "staleness_steps": record.staleness_steps,
        "staleness_us": record.staleness_us,
    }
    if record.span is not None:
        data["lineage"] = record.span
    _diag.record("lineage.observe", owner, **data)
    return record


def observe_metric(metric: Any, where: str, coverage: Optional[Dict[str, Any]] = None):
    """Observe by metric instance: keys by ``type(metric).__name__`` (the
    owner string every stats/event/quarantine site already uses) and attaches
    the record as ``metric._provenance`` for callers of ``compute()``."""
    record = note_observed(type(metric).__name__, where, coverage=coverage)
    if record is not None:
        try:
            object.__setattr__(metric, "_provenance", record)
        except (AttributeError, TypeError):
            pass  # slotted/frozen metric: the record still exists in the ledger
    return record


def observe_all(where: str) -> List[ValueProvenance]:
    """Observe every owner with watermark activity (the scrape-flush path)."""
    if not lineage_enabled():
        return []
    with _lock:
        owners = sorted(_watermarks)
    return [r for r in (note_observed(o, where) for o in owners) if r is not None]


def provenance_of(owner: str) -> Optional[ValueProvenance]:
    """The current record for ``owner`` WITHOUT advancing the observed
    watermark or feeding histograms (pure read — report/dump surfaces)."""
    if not lineage_enabled():
        return None
    with _lock:
        wm = _watermarks.get(owner)
        if wm is None:
            return None
        behind = max(0, wm.enqueued - wm.folded)
        wall_us = 0.0
        if behind and wm.pending_since_us is not None:
            wall_us = max(0.0, epoch_now_us() - wm.pending_since_us)
        return ValueProvenance(
            owner=owner,
            where="read",
            steps_enqueued=wm.enqueued,
            steps_folded=wm.folded,
            steps_observed=wm.observed,
            staleness_steps=behind,
            staleness_us=round(wall_us, 3),
            excluded=dict(wm.excluded),
            span=wm.last_span_id,
            coverage=_coverage.get(owner),
        )


def stalest_owner() -> Optional[Tuple[str, int, float]]:
    """``(owner, steps_behind, wall_us_behind)`` for the most stale owner, or
    ``None`` when every owner is caught up — the ``/healthz`` 503 detail."""
    if not lineage_enabled():
        return None
    worst: Optional[Tuple[str, int, float]] = None
    now = epoch_now_us()
    with _lock:
        for owner in sorted(_watermarks):
            wm = _watermarks[owner]
            behind = max(0, wm.enqueued - wm.folded)
            if behind <= 0:
                continue
            wall = max(0.0, now - wm.pending_since_us) if wm.pending_since_us is not None else 0.0
            if worst is None or (behind, wall) > (worst[1], worst[2]):
                worst = (owner, behind, round(wall, 3))
    return worst


def lineage_snapshot() -> Dict[str, Any]:
    """The whole ledger as a deterministic dict (telemetry/report/dump)."""
    if not lineage_enabled():
        return {"enabled": False, "owners": {}}
    with _lock:
        owners = sorted(_watermarks)
    rows = {}
    for owner in owners:
        record = provenance_of(owner)
        if record is not None:
            rows[owner] = record.as_dict()
    return {"enabled": True, "owners": rows}


# ------------------------------------------------------------------ headers

def encode_lineage_header(records: Sequence[Any]) -> str:
    """Compact single-line JSON for the :data:`LINEAGE_HEADER` stamp.

    Accepts :class:`ValueProvenance` records or their ``as_dict()`` form (the
    snapshot path carries the dict). One object per owner, sorted by owner,
    separators tightened — the same bytes for the same ledger state, so
    envelope tests can assert equality.
    """
    rows = sorted(
        (r.as_dict() if isinstance(r, ValueProvenance) else dict(r) for r in records),
        key=lambda d: d["owner"],
    )
    return json.dumps(rows, separators=(",", ":"), sort_keys=True)


def decode_lineage_header(text: str) -> List[Dict[str, Any]]:
    """Parse a :data:`LINEAGE_HEADER` stamp (ingest side; fail-loud)."""
    rows = json.loads(text)
    if not isinstance(rows, list):
        raise _user_error(
            f"{LINEAGE_HEADER} header must be a JSON list of provenance rows,"
            f" got {type(rows).__name__}."
        )
    return rows


# ------------------------------------------------------------------ reset

def reset_lineage() -> None:
    """Drop every watermark, span, and coverage stamp (lockstep with
    :func:`~torchmetrics_tpu_torch.engine.stats.reset_engine_stats` — a stale
    watermark would attribute the previous scenario's backlog to the fresh
    run as phantom staleness)."""
    global _span_counter
    with _lock:
        _watermarks.clear()
        _coverage.clear()
        _span_counter = 0
