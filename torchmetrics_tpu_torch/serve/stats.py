"""Serving-layer counters, object registries, and env knobs (counterpart of
``torchmetrics_tpu/serve/stats.py``, the same names, bounds and texts).

Import-light on purpose (no Metric / engine imports): ``diag/telemetry.py``
pulls :func:`serve_state` into every scrape, and the serve objects register
themselves here at construction — a :class:`weakref.WeakValueDictionary`
keyed by ``id(obj)`` (NEVER a WeakSet: ``Metric.__hash__`` covers live state
array ids and changes every update).

Env contract: unrecognized values FAIL LOUD with
:class:`~torchmetrics_tpu_torch.utilities.exceptions.TorchMetricsUserError` instead
of silently disabling the knob.

- ``TORCHMETRICS_TPU_SERVE_CAPACITY`` — default tenant-slot capacity for
  :class:`~torchmetrics_tpu_torch.serve.tenancy.TenantSlices` (power-of-two int).
- ``TORCHMETRICS_TPU_SERVE_PORT`` — default bind port for
  :class:`~torchmetrics_tpu_torch.serve.sidecar.MetricsSidecar` (0 = ephemeral).
- ``TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES`` — consistency-retry budget for
  :func:`~torchmetrics_tpu_torch.serve.snapshot.take_snapshot`.
- ``TORCHMETRICS_TPU_FEDERATION_RETRIES`` — bounded-pull retry budget for
  :class:`~torchmetrics_tpu_torch.serve.federation.FederationAggregator`.
- ``TORCHMETRICS_TPU_FLEET_PULL_MS`` — per-pull deadline (ms) for
  :class:`~torchmetrics_tpu_torch.serve.fleet.FleetTelemetry` telemetry rounds
  (unset/0 = no deadline).
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict

from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "federation_retries",
    "fleet_pull_ms",
    "note_scrape",
    "note_snapshot",
    "register_federation",
    "register_fleet",
    "register_sketch",
    "register_tenancy",
    "reset_serve_stats",
    "serve_state",
]

_LOCK = threading.Lock()

#: process-wide monotonic counters (scrapes come from the sidecar thread, so
#: every bump takes the lock; the hot update loop never touches these)
_COUNTERS: Dict[str, float] = {  # guarded-by: _LOCK
    "scrapes": 0,
    "scrape_seconds": 0.0,
    "snapshots": 0,
    "snapshot_retries": 0,
}

#: registries keyed by a process-stable registration sequence number — the
#: number becomes part of the Prometheus owner label, so two live instances of
#: the same class can never emit duplicate label sets (which would fail the
#: whole scrape at the Prometheus parser)
_SEQ = iter(range(1, 1 << 62)).__next__
_TENANCIES: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_SKETCHES: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_FEDERATIONS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()
_FLEETS: "weakref.WeakValueDictionary[int, Any]" = weakref.WeakValueDictionary()


def register_tenancy(obj: Any) -> None:
    _TENANCIES[_SEQ()] = obj


def register_sketch(obj: Any) -> None:
    _SKETCHES[_SEQ()] = obj


def register_federation(obj: Any) -> None:
    _FEDERATIONS[_SEQ()] = obj


def register_fleet(obj: Any) -> None:
    _FLEETS[_SEQ()] = obj


def note_scrape(seconds: float) -> None:
    with _LOCK:
        _COUNTERS["scrapes"] += 1
        _COUNTERS["scrape_seconds"] += float(seconds)


def note_snapshot(retries: int) -> None:
    with _LOCK:
        _COUNTERS["snapshots"] += 1
        _COUNTERS["snapshot_retries"] += int(retries)


def reset_serve_stats() -> None:
    """Zero the counters (registries are weak — they empty themselves)."""
    with _LOCK:
        _COUNTERS.update(scrapes=0, scrape_seconds=0.0, snapshots=0, snapshot_retries=0)


def serve_state() -> Dict[str, Any]:
    """One JSON-serializable dict for telemetry: counters + live-object gauges.

    Gauge reads (tenant counts, sketch fill ratios) are host transfers by
    design and ride each object's own sanctioned boundary — this is the
    scrape path, not the hot loop.
    """
    with _LOCK:
        out: Dict[str, Any] = dict(_COUNTERS)

    def _note_failed(owner: str, exc: Exception) -> None:
        # a half-built object must not kill a scrape, but the
        # skip must not be silent either — it lands in the flight recorder
        from torchmetrics_tpu_torch.diag import trace as _diag

        _diag.record("serve.scrape.error", owner, error=f"{type(exc).__name__}: {exc}")

    tenants = []
    for seq, obj in sorted(_TENANCIES.items()):
        owner = f"{type(obj).__name__}#{seq}"
        try:
            tenants.append({
                "owner": owner,
                "tenants": obj.tenant_count(),
                "spilled": obj.spilled_count(),
            })
        except Exception as exc:  # noqa: BLE001
            _note_failed(owner, exc)
    sketches = []
    for seq, obj in sorted(_SKETCHES.items()):
        owner = f"{type(obj).__name__}#{seq}"
        try:
            sketches.append({"owner": owner, "fill_ratio": obj.fill_ratio()})
        except Exception as exc:  # noqa: BLE001
            _note_failed(owner, exc)
    out["tenancies"] = sorted(tenants, key=lambda t: t["owner"])
    out["sketches"] = sorted(sketches, key=lambda s: s["owner"])
    federations = []
    for seq, obj in sorted(_FEDERATIONS.items()):
        owner = f"{type(obj).__name__}#{seq}"
        try:
            federations.append({"owner": owner, **obj.federation_state()})
        except Exception as exc:  # noqa: BLE001
            _note_failed(owner, exc)
    out["federations"] = sorted(federations, key=lambda f: f["owner"])
    fleets = []
    for seq, obj in sorted(_FLEETS.items()):
        owner = f"{type(obj).__name__}#{seq}"
        try:
            fleets.append({"owner": owner, **obj.fleet_state()})
        except Exception as exc:  # noqa: BLE001
            _note_failed(owner, exc)
    out["fleets"] = sorted(fleets, key=lambda f: f["owner"])
    return out


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        value = None
    if value is None or not (lo <= value <= hi):
        raise TorchMetricsUserError(
            f"Invalid {name}={raw!r}: expected an integer in [{lo}, {hi}]."
            " Unset the variable to use the default."
        )
    return value


def default_capacity() -> int:
    cap = _env_int("TORCHMETRICS_TPU_SERVE_CAPACITY", 4096, 2, 1 << 24)
    if cap & (cap - 1):
        raise TorchMetricsUserError(
            f"Invalid TORCHMETRICS_TPU_SERVE_CAPACITY={cap}: must be a power of two"
            " (the tenant table probes with power-of-two masking)."
        )
    return cap


def default_port() -> int:
    return _env_int("TORCHMETRICS_TPU_SERVE_PORT", 0, 0, 65535)


def snapshot_retries() -> int:
    return _env_int("TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES", 8, 1, 1000)


def federation_retries() -> int:
    return _env_int("TORCHMETRICS_TPU_FEDERATION_RETRIES", 2, 0, 100)


def fleet_pull_ms() -> "float | None":
    """Per-pull deadline (ms) for fleet telemetry rounds; None = no deadline."""
    value = _env_int("TORCHMETRICS_TPU_FLEET_PULL_MS", 0, 0, 86_400_000)
    return float(value) if value else None
