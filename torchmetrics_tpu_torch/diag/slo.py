"""Declarative SLO engine — rolling-window objectives over the evidence plane
(counterpart of ``torchmetrics_tpu/diag/slo.py``: the same registry, windows and rows).

The counters (``engine/stats.py``), latency distributions (``diag/hist.py``) and
events (``diag/trace.py``) record facts; this module judges them: a declarative
registry of Service Level Objectives (:data:`SLO_REGISTRY`) binds each objective to
a histogram series or a counter field, evaluated over rolling windows with a
fast/slow burn-rate pair. The serving sidecar's ``/healthz`` readiness gate
(``serve/sidecar.py``) consumes it.

Spec anatomy (one :data:`SLO_REGISTRY` entry, pure literals):

- ``signal`` — a histogram series name (``diag/telemetry.py`` ``_HIST_SERIES``
  key, e.g. ``sync_us``) or an :class:`~torchmetrics_tpu_torch.engine.stats.
  EngineStats` counter field (e.g. ``sync_degraded_folds``).
- ``kind`` — ``quantile`` (windowed quantile of a histogram series vs a
  threshold, needs ``q``), ``rate`` (counter delta over the window vs a
  threshold), or ``ratio`` (counter delta divided by a ``denominator``
  counter's delta vs a threshold; an idle window — zero denominator — is
  compliant, not a division error).
- ``threshold`` — the objective bound; a measurement strictly above it
  violates. ``threshold: 0.0`` with ``kind: rate`` means "this counter must
  not move at all inside the window".
- ``blocking`` — whether a breach flips ``/healthz`` readiness to 503
  (``True``) or only raises the alerting surface — events, the
  ``tm_tpu_slo_breaches_total`` counter, per-SLO compliance gauges
  (``False``).

Burn-rate semantics (the fast/slow window pair, default slow window 300 s,
fast = slow / 10): a spec transitions to *breach* only when BOTH windows
violate — the slow window proves the problem is sustained, the fast window
proves it is still happening. It transitions back to *healthy* as soon as the
FAST window clears — recovery should be observed at the fast horizon, not
delayed by the slow window draining. With fewer samples than a full window,
the windows clip to the recorded history, so a cold engine's first violating
evaluation can breach — an SLO engine that stays green for its first five
minutes regardless of input would be worse than none.

Transitions are evidence, not just state: each one records a ``slo.breach`` /
``slo.recover`` flight-recorder event and bumps the ``slo_breaches`` /
``slo_recoveries`` counters; every pass bumps ``slo_evaluations``. The same
specs evaluate identically per-pod (default: the local registries) and
fleet-wide (``serve/fleet.py`` passes the merged histograms + summed counters
as explicit ``inputs``) — one objective language for one pod or forty.

Env knob (fail-loud): ``TORCHMETRICS_TPU_SLO`` — unset
uses the 300 s default slow window; a positive number overrides it (seconds);
``0`` / ``off`` disables SLO evaluation (``/healthz`` skips the SLO gate);
anything else raises :class:`~torchmetrics_tpu_torch.utilities.exceptions.
TorchMetricsUserError`. Tests use :func:`slo_context` instead of
mutating the environment.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from time import monotonic
from typing import Any, Deque, Dict, Generator, List, Optional, Tuple

from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.diag.hist import BOUNDS, Histogram
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "SLO_REGISTRY",
    "SLOSpec",
    "SLOEngine",
    "blocking_breaches",
    "evaluate_slos",
    "reset_slo",
    "slo_context",
    "slo_enabled",
    "slo_state",
]

#: Default slow burn window (seconds); the fast window is slow / 10.
DEFAULT_SLOW_WINDOW_S = 300.0

#: The declarative SLO table: every objective the package evaluates, as pure
#: literals, the JAX package's row for row.
SLO_REGISTRY = {
    # fleet-wide p99 packed-sync latency objective: the paper's serving bound.
    # sync_us is recorded in microseconds; 5000 µs = 5 ms.
    "sync-latency-p99": {
        "signal": "sync_us",
        "kind": "quantile",
        "q": 0.99,
        "threshold": 5000.0,
        "blocking": False,
    },
    # degraded packed syncs mean a rank/pod dropped out of the membership —
    # any movement inside the window is a readiness problem, not a trend
    "sync-degraded-folds": {
        "signal": "sync_degraded_folds",
        "kind": "rate",
        "threshold": 0.0,
        "blocking": True,
    },
    # poisoned-batch quarantines per compiled dispatch — a trickle is the
    # mechanism working; a ratio above 1e-3 means the input pipeline is sick
    "quarantine-ratio": {
        "signal": "quarantined_batches",
        "kind": "ratio",
        "denominator": "dispatches",
        "threshold": 1e-3,
        "blocking": False,
    },
    # fleet staleness bound: pods excluded from a telemetry pull/merge round
    # (fault, stale watermark) — any exclusion flips fleet readiness
    "fleet-degraded-pulls": {
        "signal": "fleet_degraded_pulls",
        "kind": "rate",
        "threshold": 0.0,
        "blocking": True,
    },
    # value-freshness objective (diag/lineage.py): p99 steps-behind at
    # observation time. A pod whose observed values trail their enqueue
    # watermark by more than 32 steps is serving stale answers — blocking, so
    # /healthz drains it (naming the stale owner) until the fold catches up
    "value-freshness": {
        "signal": "staleness_steps",
        "kind": "quantile",
        "q": 0.99,
        "threshold": 32.0,
        "blocking": True,
    },
    # wall-clock companion bound: p99 age of the oldest unfolded enqueue at
    # observation time, in µs (5e6 = 5 s). Advisory — step-lag is the
    # authoritative freshness signal; this catches a stalled drain thread
    # whose step-lag is small but old
    "value-staleness-wall": {
        "signal": "staleness_us",
        "kind": "quantile",
        "q": 0.99,
        "threshold": 5000000.0,
        "blocking": False,
    },
}

_KINDS = ("quantile", "rate", "ratio")


@dataclass(frozen=True)
class SLOSpec:
    """One validated objective (the runtime form of a registry row)."""

    id: str
    signal: str
    kind: str
    threshold: float
    q: Optional[float] = None
    denominator: Optional[str] = None
    blocking: bool = False

    @staticmethod
    def from_registry(slo_id: str, row: Dict[str, Any]) -> "SLOSpec":
        kind = row["kind"]
        if kind not in _KINDS:
            raise TorchMetricsUserError(
                f"SLO {slo_id!r} has unknown kind {kind!r}; expected one of {_KINDS}."
            )
        if kind == "quantile" and not (0.0 < float(row.get("q", 0.0)) <= 1.0):
            raise TorchMetricsUserError(
                f"SLO {slo_id!r} is a quantile objective and needs 0 < q <= 1."
            )
        if kind == "ratio" and not row.get("denominator"):
            raise TorchMetricsUserError(
                f"SLO {slo_id!r} is a ratio objective and needs a denominator counter."
            )
        return SLOSpec(
            id=slo_id,
            signal=row["signal"],
            kind=kind,
            threshold=float(row["threshold"]),
            q=float(row["q"]) if "q" in row else None,
            denominator=row.get("denominator"),
            blocking=bool(row.get("blocking", False)),
        )


def _specs() -> Tuple[SLOSpec, ...]:
    return tuple(SLOSpec.from_registry(k, SLO_REGISTRY[k]) for k in sorted(SLO_REGISTRY))


# ------------------------------------------------------------------ env knob

_SLO_ENV_VAR = "TORCHMETRICS_TPU_SLO"

# context override installed by slo_context(): (slow_s, fast_s) or None
_window_override: Optional[Tuple[float, float]] = None


def _env_slo() -> Optional[float]:
    """The ONE recognized parser for ``TORCHMETRICS_TPU_SLO`` (fail-loud).

    Returns the slow-window seconds, or ``None`` when SLO evaluation is
    disabled (``0`` / ``off``).
    """
    raw = os.environ.get(_SLO_ENV_VAR)
    if raw is None:
        return DEFAULT_SLOW_WINDOW_S
    text = raw.strip().lower()
    if text in ("0", "off"):
        return None
    try:
        value = float(text)
    except ValueError:
        value = -1.0
    if value <= 0.0:
        raise TorchMetricsUserError(
            f"Invalid {_SLO_ENV_VAR}={raw!r}: expected a positive slow-window"
            " duration in seconds, or '0'/'off' to disable SLO evaluation."
            " Unset the variable to use the default"
            f" ({DEFAULT_SLOW_WINDOW_S:.0f} s)."
        )
    return value


def slo_enabled() -> bool:
    """Whether SLO evaluation is on (a :func:`slo_context` override wins)."""
    if _window_override is not None:
        return True
    return _env_slo() is not None


def _windows() -> Tuple[float, float]:
    """Active ``(slow_s, fast_s)`` pair (assumes :func:`slo_enabled`)."""
    if _window_override is not None:
        return _window_override
    slow = _env_slo()
    slow = DEFAULT_SLOW_WINDOW_S if slow is None else slow
    return slow, slow / 10.0


@contextmanager
def slo_context(slow_s: float, fast_s: Optional[float] = None) -> Generator:
    """Scoped window override (tests — no environment mutation)."""
    global _window_override
    if slow_s <= 0.0:
        raise TorchMetricsUserError(f"slo_context needs slow_s > 0, got {slow_s!r}")
    prev = _window_override
    _window_override = (float(slow_s), float(fast_s) if fast_s else float(slow_s) / 10.0)
    try:
        yield
    finally:
        _window_override = prev


# ------------------------------------------------------------------ engine

def _merged_series(series: str) -> Histogram:
    """The local process's histogram for ``series``, merged across owners."""
    from torchmetrics_tpu_torch.diag.hist import histogram_items, merge_hists

    out = Histogram()
    for (_owner, _kind, name), hist in histogram_items():
        if name == series:
            out = merge_hists(out, hist)
    return out


def _local_inputs() -> Dict[str, Any]:
    from torchmetrics_tpu_torch.engine.stats import _COUNTER_FIELDS, engine_report

    report = engine_report()
    counters = {f: int(report.get(f, 0)) for f in _COUNTER_FIELDS}
    return {"counters": counters, "series": _merged_series}


class SLOEngine:
    """Rolling-window evaluator over one input surface (pod or fleet).

    One instance holds the per-spec sample windows and compliance state; the
    module-level singleton evaluates the local process, and
    ``serve/fleet.py`` owns a second instance fed with merged fleet inputs —
    same specs, same semantics, different measurement surface.
    """

    def __init__(self, owner: str = "slo") -> None:
        from torchmetrics_tpu_torch.engine.stats import EngineStats

        self.owner = owner
        self.stats = EngineStats(owner)
        self._lock = threading.Lock()
        # spec id -> deque of (ts, snapshot); snapshot is a counts list for
        # quantile specs (monotone — window delta = elementwise subtraction)
        # or a (num, denom) counter pair for rate/ratio specs
        self._samples: Dict[str, Deque[Tuple[float, Any]]] = {}
        self._breaching: Dict[str, bool] = {}
        self._last: Dict[str, Optional[float]] = {}

    # -- window measurement ------------------------------------------------

    @staticmethod
    def _window_floor(window: Deque[Tuple[float, Any]], now: float, span: float):
        """Newest sample at or before ``now - span`` (window baseline); clips
        to the oldest recorded sample when history is shorter than the span."""
        floor = window[0]
        for ts, snap in window:
            if ts <= now - span:
                floor = (ts, snap)
            else:
                break
        return floor

    def _measure(self, spec: SLOSpec, window, now: float, span: float) -> Optional[float]:
        """The windowed measurement, or None when the window has no signal."""
        _, oldest = self._window_floor(window, now, span)
        _, newest = window[-1]
        if spec.kind == "quantile":
            delta = Histogram()
            delta.counts = [n - o for n, o in zip(newest, oldest)]
            delta.total = sum(delta.counts)
            if delta.total <= 0:
                return None
            # per-sample min/max are not recoverable from a counts delta; an
            # overflow-bucket rank resolves to the top boundary — finite, and
            # "at least this large" violates any realistic threshold
            delta.sum = 0.0
            delta.max = BOUNDS[-1]
            q = delta.quantile(spec.q if spec.q is not None else 0.99)
            return None if q is None else float(q)
        num_new, den_new = newest
        num_old, den_old = oldest
        moved = float(num_new - num_old)
        if spec.kind == "rate":
            return moved
        denom = float(den_new - den_old)
        if denom <= 0.0:
            return None  # idle window: compliant by definition
        return moved / denom

    # -- evaluation --------------------------------------------------------

    def evaluate(
        self, inputs: Optional[Dict[str, Any]] = None, now: Optional[float] = None
    ) -> List[Dict[str, Any]]:
        """Evaluate every registered spec once; returns the per-spec rows.

        ``inputs`` defaults to the local process (live histogram registry +
        ``engine_report`` counters); the fleet plane passes merged inputs.
        ``now`` is injectable so tests drive window time explicitly.
        """
        if not slo_enabled():
            return []
        if inputs is None:
            inputs = _local_inputs()
        counters: Dict[str, int] = inputs.get("counters", {})
        series_fn = inputs.get("series") or (lambda name: Histogram())
        ts = monotonic() if now is None else float(now)
        slow_s, fast_s = _windows()
        rows: List[Dict[str, Any]] = []
        with self._lock:
            self.stats.slo_evaluations += 1
            for spec in _specs():
                if spec.kind == "quantile":
                    snap: Any = list(series_fn(spec.signal).counts)
                else:
                    snap = (
                        int(counters.get(spec.signal, 0)),
                        int(counters.get(spec.denominator, 0)) if spec.denominator else 0,
                    )
                window = self._samples.setdefault(spec.id, deque())
                window.append((ts, snap))
                while len(window) > 2 and window[1][0] <= ts - slow_s:
                    window.popleft()
                fast = self._measure(spec, window, ts, fast_s)
                slow = self._measure(spec, window, ts, slow_s)
                fast_violates = fast is not None and fast > spec.threshold
                slow_violates = slow is not None and slow > spec.threshold
                was = self._breaching.get(spec.id, False)
                # breach needs BOTH burn windows; recovery follows the FAST one
                breaching = (fast_violates and slow_violates) if not was else fast_violates
                if breaching and not was:
                    self.stats.slo_breaches += 1
                    _diag.record(
                        "slo.breach", spec.id, signal=spec.signal,
                        measured=fast, threshold=spec.threshold, blocking=spec.blocking,
                    )
                elif was and not breaching:
                    self.stats.slo_recoveries += 1
                    _diag.record(
                        "slo.recover", spec.id, signal=spec.signal,
                        measured=fast, threshold=spec.threshold, blocking=spec.blocking,
                    )
                self._breaching[spec.id] = breaching
                self._last[spec.id] = fast if fast is not None else slow
                rows.append({
                    "id": spec.id,
                    "signal": spec.signal,
                    "kind": spec.kind,
                    "threshold": spec.threshold,
                    "blocking": spec.blocking,
                    "measured": self._last[spec.id],
                    "fast_violates": fast_violates,
                    "slow_violates": slow_violates,
                    "breaching": breaching,
                })
        return rows

    def state(self) -> List[Dict[str, Any]]:
        """Last-known per-spec compliance rows (no re-evaluation)."""
        with self._lock:
            return [
                {
                    "id": spec.id,
                    "signal": spec.signal,
                    "kind": spec.kind,
                    "threshold": spec.threshold,
                    "blocking": spec.blocking,
                    "measured": self._last.get(spec.id),
                    "breaching": self._breaching.get(spec.id, False),
                }
                for spec in _specs()
            ]

    def blocking_breaches(self) -> List[str]:
        """Ids of blocking specs currently in breach (readiness gate input)."""
        with self._lock:
            blocking = {s.id for s in _specs() if s.blocking}
            return sorted(sid for sid, b in self._breaching.items() if b and sid in blocking)

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._breaching.clear()
            self._last.clear()


# lazy module-level singleton: the local-process evaluator
_ENGINE: Optional[SLOEngine] = None
_ENGINE_LOCK = threading.Lock()


def _engine() -> SLOEngine:
    global _ENGINE
    if _ENGINE is None:
        with _ENGINE_LOCK:
            if _ENGINE is None:
                _ENGINE = SLOEngine("slo")
    return _ENGINE


def evaluate_slos(
    inputs: Optional[Dict[str, Any]] = None, now: Optional[float] = None
) -> List[Dict[str, Any]]:
    """Evaluate every SLO on the local singleton (see :meth:`SLOEngine.evaluate`)."""
    return _engine().evaluate(inputs=inputs, now=now)


def slo_state() -> List[Dict[str, Any]]:
    """Last-known local compliance rows (telemetry/scrape surface)."""
    return _engine().state()


def blocking_breaches() -> List[str]:
    """Blocking SLOs currently in breach locally (``/healthz`` consumes this)."""
    return _engine().blocking_breaches()


def reset_slo() -> None:
    """Drop windows + compliance state (``reset_engine_stats`` lockstep)."""
    if _ENGINE is not None:
        _ENGINE.reset()
