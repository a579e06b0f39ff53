"""Fleet observability plane: cross-pod telemetry federation (counterpart of
``torchmetrics_tpu/serve/fleet.py``).

``serve/federation.py`` folds the metric values across pods; this module folds the
evidence. Every pod exports counters (``engine/stats.py``), latency distributions
(``diag/hist.py``), sentinel bitmasks and the cost-ledger totals:

- **Telemetry envelope** (:func:`pack_telemetry` / :func:`parse_telemetry`): one
  pod's surface as a self-verifying ``.npz`` payload with the federation envelope's
  version / CRC / sequence stamps, served by the sidecar as ``GET /telemetry.bin``.
  Histograms travel as bucket-count vectors over the shared geometric
  :data:`~torchmetrics_tpu_torch.diag.hist.BOUNDS`, so the merge is exact bucket
  addition.
- **Aggregator** (:class:`FleetTelemetry`): pods are URLs or callables; every fetch
  runs through :func:`~torchmetrics_tpu_torch.parallel.resilience.bounded_pull` on a
  ``fleet-pull:<pod>`` label; a lost pod is a counted ``fleet.degraded`` exclusion,
  never a hang; a stale sequence number is rejected at the watermark.
- **Merge** (:meth:`FleetTelemetry.merge`): counters sum; histograms merge
  bucket-wise (``merge_hists``: the union-stream histogram, so the ≤ 18.92 %
  one-sided quantile bound holds for the fleet); sentinel bitmasks OR per owner;
  reason maps sum key-wise; ledger totals sum (``peak_bytes_max`` by max).
- **Fleet exposition** (:meth:`FleetTelemetry.export_prometheus`): pod-labelled
  series and ``tm_tpu_fleet_*`` families, byte-stable under pod ingest order.
- **Fleet SLOs**: the aggregator owns its own
  :class:`~torchmetrics_tpu_torch.diag.slo.SLOEngine` and evaluates the shared
  :data:`~torchmetrics_tpu_torch.diag.slo.SLO_REGISTRY` over the merged inputs.

Env knob (fail-loud): ``TORCHMETRICS_TPU_FLEET_PULL_MS``, the per-pull deadline in
milliseconds (unset or 0: no deadline).
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.diag.hist import (
    Histogram,
    hist_from_arrays,
    hist_to_arrays,
    merge_hists,
)
from torchmetrics_tpu_torch.diag.slo import SLOEngine
from torchmetrics_tpu_torch.engine.stats import _COUNTER_FIELDS, EngineStats
from torchmetrics_tpu_torch.parallel.elastic import SnapshotIntegrityError, SnapshotVersionError
from torchmetrics_tpu_torch.parallel.resilience import (
    SyncFaultError,
    bounded_pull,
    resilience_context,
)
from torchmetrics_tpu_torch.serve import stats as _serve_stats
from torchmetrics_tpu_torch.serve.federation import (
    CRC_HEADER,
    SEQ_HEADER,
    VERSION_HEADER,
    _http_fetcher,
    _payload_crc,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "FLEET_LAYOUT_VERSION",
    "FleetTelemetry",
    "PodTelemetry",
    "local_telemetry",
    "pack_telemetry",
    "parse_telemetry",
]

#: telemetry-envelope layout version — bumped on any change to the key scheme,
#: the JSON blob layout, or the CRC coverage; a mismatch is a typed refusal
FLEET_LAYOUT_VERSION = 1

_HIST_KEY = "hist"  # npz key prefix: hist::{owner}::{kind}::{series}
_META_KEY = "histmeta"  # float64 [total, sum, min, max] sibling of each hist

#: reason-map names merged key-wise across pods (EngineStats Counter attrs)
_REASON_MAPS = ("fallback_reasons", "retrace_causes", "scan_flush_reasons")

#: ledger-totals field folded by MAX instead of sum (a peak is not additive)
_LEDGER_MAX_FIELDS = ("peak_bytes_max",)

# process start reference for the uptime stamp
_T0 = time.monotonic()


@dataclass
class PodTelemetry:
    """One pod's verified telemetry envelope, parsed back into merge-ready form."""

    counters: Dict[str, int]
    reasons: Dict[str, Dict[str, int]]  # map name -> {reason: count}
    sentinels: List[Dict[str, Any]]  # [{"owner": ..., "flags": bitmask}, ...]
    ledger_totals: Dict[str, float]
    hists: Dict[Tuple[str, str, str], Histogram]  # (owner, kind, series)
    seq: int
    uptime_s: float


def local_telemetry(seq: Optional[int] = None) -> Dict[str, Any]:
    """This process's telemetry surface as one pack-ready dict.

    ``seq`` defaults to the summed engine counters — monotonic between resets,
    which is all the aggregator's watermark dedupe needs. Emulated pods (tests)
    build synthetic dicts of the same shape instead.
    """
    from torchmetrics_tpu_torch.diag.costs import ledger_snapshot
    from torchmetrics_tpu_torch.diag.hist import histogram_items
    from torchmetrics_tpu_torch.diag.sentinel import sentinel_report
    from torchmetrics_tpu_torch.engine.stats import engine_report

    report = engine_report()
    counters = {f: int(report.get(f, 0)) for f in _COUNTER_FIELDS}
    if seq is None:
        seq = sum(counters.values())
    return {
        "counters": counters,
        "reasons": {name: dict(report.get(name, {})) for name in _REASON_MAPS},
        "sentinels": [
            {"owner": s["owner"], "flags": int(s["flags"])} for s in sentinel_report()
        ],
        "ledger_totals": {k: float(v) for k, v in ledger_snapshot()["totals"].items()},
        "hists": {key: hist for key, hist in histogram_items()},
        "seq": int(seq),
        "uptime_s": time.monotonic() - _T0,
    }


def pack_telemetry(
    snapshot: Optional[Dict[str, Any]] = None, seq: Optional[int] = None
) -> Tuple[bytes, Dict[str, str]]:
    """Serialize one pod's telemetry into a self-verifying envelope.

    Returns ``(payload_bytes, headers)`` with the same version/CRC/seq header
    contract the ``/state`` federation envelope carries — the sidecar serves
    the bytes as ``GET /telemetry.bin`` and stamps the headers verbatim.
    """
    snap = snapshot if snapshot is not None else local_telemetry(seq=seq)
    flat: Dict[str, np.ndarray] = {}
    hist_keys: List[List[str]] = []
    for (owner, kind, series), hist in sorted(snap.get("hists", {}).items()):
        counts, meta = hist_to_arrays(hist)
        flat[f"{_HIST_KEY}::{owner}::{kind}::{series}"] = np.asarray(counts, dtype=np.int64)
        flat[f"{_META_KEY}::{owner}::{kind}::{series}"] = np.asarray(meta, dtype=np.float64)
        hist_keys.append([owner, kind, series])
    blob = {
        "counters": snap.get("counters", {}),
        "reasons": snap.get("reasons", {}),
        "sentinels": snap.get("sentinels", []),
        "ledger_totals": snap.get("ledger_totals", {}),
        "uptime_s": float(snap.get("uptime_s", 0.0)),
        "hist_keys": hist_keys,
    }
    flat["__json__"] = np.frombuffer(
        json.dumps(blob, sort_keys=True).encode(), dtype=np.uint8
    ).copy()
    env_seq = int(snap.get("seq", 0)) if seq is None else int(seq)
    flat["__fleet_version__"] = np.int64(FLEET_LAYOUT_VERSION)
    flat["__seq__"] = np.int64(env_seq)
    crc = _payload_crc(flat)
    flat["__crc__"] = np.uint32(crc)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    headers = {
        VERSION_HEADER: str(FLEET_LAYOUT_VERSION),
        CRC_HEADER: f"{crc:#010x}",
        SEQ_HEADER: str(env_seq),
    }
    rows = [r for r in _lineage.lineage_snapshot()["owners"].values()]
    if rows:
        # the telemetry envelope carries this pod's provenance ledger as a
        # header stamp — the fleet aggregator (or curl -I) audits per-owner
        # freshness without unpacking the npz
        headers[_lineage.LINEAGE_HEADER] = _lineage.encode_lineage_header(rows)
    return buf.getvalue(), headers


def parse_telemetry(data: bytes, headers: Optional[Mapping[str, str]] = None) -> PodTelemetry:
    """Verify a telemetry envelope (version, CRC, header cross-check), parse it.

    The same typed refusal contract as the state envelope: unreadable payloads
    and CRC mismatches raise :class:`~torchmetrics_tpu_torch.parallel.elastic.
    SnapshotIntegrityError`, a layout-version mismatch raises
    :class:`~torchmetrics_tpu_torch.parallel.elastic.SnapshotVersionError`.
    """
    if headers:
        raw_version = headers.get(VERSION_HEADER)
        if raw_version is not None and int(raw_version) != FLEET_LAYOUT_VERSION:
            raise SnapshotVersionError(
                f"pod telemetry advertises layout version {raw_version}, this build"
                f" reads {FLEET_LAYOUT_VERSION} — refusing to guess at the layout"
            )
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as npz:
            flat = {k: np.asarray(npz[k]) for k in npz.files}
    except Exception as err:  # noqa: BLE001 — unreadable IS the corruption signal
        raise SnapshotIntegrityError(f"pod telemetry payload is unreadable: {err}") from err
    for key in ("__fleet_version__", "__seq__", "__crc__", "__json__"):
        if key not in flat:
            raise SnapshotIntegrityError(
                f"pod telemetry payload lacks the {key} stamp — not a fleet envelope"
            )
    version = int(flat["__fleet_version__"])
    if version != FLEET_LAYOUT_VERSION:
        raise SnapshotVersionError(
            f"pod telemetry has layout version {version}, this build reads"
            f" {FLEET_LAYOUT_VERSION} — refusing to guess at the layout"
        )
    expected = int(flat["__crc__"])
    actual = _payload_crc(flat)
    if actual != expected:
        raise SnapshotIntegrityError(
            f"pod telemetry failed its integrity check (crc {actual:#010x} !="
            f" stamped {expected:#010x}) — the payload is corrupt"
        )
    if headers:
        raw_crc = headers.get(CRC_HEADER)
        if raw_crc is not None and int(raw_crc, 0) != expected:
            raise SnapshotIntegrityError(
                f"pod telemetry header CRC {raw_crc} disagrees with the payload stamp"
                f" {expected:#010x} — the transport delivered a different payload"
            )
    blob = json.loads(bytes(flat["__json__"]).decode())
    hists: Dict[Tuple[str, str, str], Histogram] = {}
    for owner, kind, series in blob.get("hist_keys", []):
        counts = flat[f"{_HIST_KEY}::{owner}::{kind}::{series}"]
        meta = flat[f"{_META_KEY}::{owner}::{kind}::{series}"]
        hists[(owner, kind, series)] = hist_from_arrays(counts.tolist(), meta.tolist())
    return PodTelemetry(
        counters={k: int(v) for k, v in blob.get("counters", {}).items()},
        reasons={
            name: {k: int(v) for k, v in rows.items()}
            for name, rows in blob.get("reasons", {}).items()
        },
        sentinels=list(blob.get("sentinels", [])),
        ledger_totals={k: float(v) for k, v in blob.get("ledger_totals", {}).items()},
        hists=hists,
        seq=int(flat["__seq__"]),
        uptime_s=float(blob.get("uptime_s", 0.0)),
    )


@dataclass
class _FleetSlot:
    """The latest verified telemetry held for one pod."""

    telemetry: PodTelemetry
    ts: float  # time.monotonic() at ingest — drives the staleness watermark


class FleetTelemetry:
    """Pull, verify, and merge N pods' telemetry envelopes into one plane.

    Args:
        pods: ``{pod_id: source}`` where source is a ``/telemetry.bin`` URL
            (string) or a zero-arg callable returning ``bytes`` or
            ``(bytes, headers)`` — callables let tests emulate pods
            without sockets. A :class:`~torchmetrics_tpu_torch.serve.
            federation.FederationAggregator` may be passed as ``aggregator``
            to reuse its membership (pod ids + ``/state`` URLs rewritten to
            ``/telemetry.bin``).
        staleness_s: telemetry older than this (since ingest) is excluded
            from merges as degraded. Default:
            ``TORCHMETRICS_TPU_FEDERATION_STALENESS_S`` (unset = no bound).
        pull_ms: per-pull deadline for :meth:`pull_round`. Default:
            ``TORCHMETRICS_TPU_FLEET_PULL_MS`` (unset/0 = no deadline).
        retries: bounded-pull retry budget. Default:
            ``TORCHMETRICS_TPU_FEDERATION_RETRIES`` (2).
    """

    def __init__(
        self,
        pods: Optional[Mapping[str, Any]] = None,
        aggregator: Optional[Any] = None,
        staleness_s: Optional[float] = None,
        pull_ms: Optional[float] = None,
        retries: Optional[int] = None,
    ) -> None:
        from torchmetrics_tpu_torch.parallel.resilience import _env_float

        self.pods: Dict[str, Any] = dict(pods or {})
        if aggregator is not None:
            for pid, source in aggregator.pods.items():
                self.pods.setdefault(
                    pid,
                    source.replace("/state", "/telemetry.bin")
                    if isinstance(source, str)
                    else source,
                )
        if not self.pods:
            raise TorchMetricsUserError(
                "FleetTelemetry needs at least one pod source (a /telemetry.bin"
                " URL or a callable) — an empty membership has nothing to merge."
            )
        self.staleness_s = (
            _env_float("TORCHMETRICS_TPU_FEDERATION_STALENESS_S")
            if staleness_s is None
            else float(staleness_s)
        )
        self.pull_ms = _serve_stats.fleet_pull_ms() if pull_ms is None else float(pull_ms)
        self.retries = _serve_stats.federation_retries() if retries is None else int(retries)
        self.stats = EngineStats("fleet")
        self.slo = SLOEngine("fleet-slo")
        self._lock = threading.Lock()
        self._slots: Dict[str, _FleetSlot] = {}  # guarded-by: _lock
        self._watermarks: Dict[str, int] = {}  # guarded-by: _lock
        self._excluded: set = set()  # guarded-by: _lock — pods out of the last round
        self._last_pods = 0  # guarded-by: _lock
        self._last_degraded = 0  # guarded-by: _lock
        _serve_stats.register_fleet(self)

    # ------------------------------------------------------------------ ingest

    def ingest(self, pod_id: str, data: bytes, headers: Optional[Mapping[str, str]] = None) -> bool:
        """Verify and accept one pod telemetry envelope (push path).

        Returns True when the envelope advanced the pod's watermark; False
        when the watermark dedupe rejected it as stale (counted, evented,
        never merged twice).
        """
        telemetry = parse_telemetry(data, headers)
        with self._lock:
            prev = self._watermarks.get(pod_id)
            if prev is not None and telemetry.seq <= prev:
                _diag.record(
                    "fleet.stale", "fleet",
                    pod=pod_id, seq=telemetry.seq, watermark=prev,
                )
                return False
            self._excluded.discard(pod_id)
            self._slots[pod_id] = _FleetSlot(telemetry=telemetry, ts=time.monotonic())
            self._watermarks[pod_id] = telemetry.seq
            self.stats.fleet_pulls += 1
        _diag.record(
            "fleet.pull", "fleet", pod=pod_id, seq=telemetry.seq, bytes=len(data),
        )
        return True

    def pull_round(self) -> Dict[str, bool]:
        """Pull every pod's ``/telemetry.bin`` once (bounded, classified).

        Same contract as the federation round: each fetch rides
        :func:`~torchmetrics_tpu_torch.parallel.resilience.bounded_pull` under a
        ``fleet-pull:<pod>`` label — deadline watchdog, retry/backoff, typed
        fault classification, and the chaos-injection hook. A terminally
        failed pod is excluded (``fleet.degraded``, counted) until it is
        ingested again; the round never raises for one lost pod.
        """
        pod_ids = sorted(self.pods)
        member_idx = {pid: i for i, pid in enumerate(pod_ids)}
        results: Dict[str, bool] = {}
        timeout_s = self.pull_ms / 1e3 if self.pull_ms else None
        with resilience_context(deadline_ms=self.pull_ms, retries=self.retries):
            for pid in pod_ids:
                source = self.pods[pid]
                fetch = source if callable(source) else _http_fetcher(source, timeout_s)
                try:
                    out = bounded_pull(
                        fetch,
                        label=f"fleet-pull:{pid}",
                        rank=member_idx[pid],
                        members=[member_idx[pid]],
                    )
                except SyncFaultError as exc:
                    with self._lock:
                        self._excluded.add(pid)
                        self.stats.fleet_degraded_pulls += 1
                    _diag.record(
                        "fleet.degraded", "fleet",
                        pod=pid, reason=type(exc).__name__, attempts=exc.attempts,
                    )
                    results[pid] = False
                    continue
                data, headers = out if isinstance(out, tuple) else (out, None)
                results[pid] = self.ingest(pid, data, headers)
        return results

    # ------------------------------------------------------------------ merge

    def _fresh_membership(self) -> Tuple[Dict[str, _FleetSlot], List[str], List[Tuple[str, str]]]:
        now = time.monotonic()
        with self._lock:
            slots = dict(self._slots)
            known = sorted(set(self.pods) | set(slots))
        fresh: Dict[str, _FleetSlot] = {}
        for pid in sorted(slots):
            slot = slots[pid]
            if self.staleness_s is not None and now - slot.ts > self.staleness_s:
                continue
            fresh[pid] = slot
        members = sorted(fresh)
        excluded = [
            (pid, "stale" if pid in slots else "missing") for pid in known if pid not in fresh
        ]
        return fresh, members, excluded

    def merge(self) -> Dict[str, Any]:
        """One fleet-wide telemetry merge over the fresh membership.

        Counters sum; histograms merge bucket-wise per series (the exact
        union-stream histogram — the GROWTH quantile bound is preserved);
        sentinel bitmasks OR per owner; reason maps merge key-wise by sum;
        ledger totals sum with ``peak_bytes_max`` folded by max. Excluded
        pods (stale, unreachable, never pulled) are counted and evented —
        degraded, never wrong, never hung. Raises
        :class:`~torchmetrics_tpu_torch.utilities.exceptions.TorchMetricsUserError`
        when no pod has ever been verified (nothing to answer with).
        """
        fresh, members, excluded = self._fresh_membership()
        if not members:
            raise TorchMetricsUserError(
                "Fleet merge has no verified pod telemetry to merge — ingest or"
                " pull at least one pod before asking for a fleet view."
            )
        counters: Dict[str, int] = {f: 0 for f in _COUNTER_FIELDS}
        reasons: Dict[str, Dict[str, int]] = {name: {} for name in _REASON_MAPS}
        sentinels: Dict[str, int] = {}
        ledger: Dict[str, float] = {}
        series_hists: Dict[str, Histogram] = {}
        pods_view: Dict[str, Dict[str, Any]] = {}
        now = time.monotonic()
        max_seq = max(fresh[pid].telemetry.seq for pid in members)
        for pid in members:
            slot = fresh[pid]
            tel = slot.telemetry
            for f in _COUNTER_FIELDS:
                counters[f] += tel.counters.get(f, 0)
            for name in _REASON_MAPS:
                merged = reasons[name]
                for reason, n in tel.reasons.get(name, {}).items():
                    merged[reason] = merged.get(reason, 0) + int(n)
            for row in tel.sentinels:
                owner = str(row.get("owner", ""))
                sentinels[owner] = sentinels.get(owner, 0) | int(row.get("flags", 0))
            for key, value in tel.ledger_totals.items():
                if key in _LEDGER_MAX_FIELDS:
                    ledger[key] = max(ledger.get(key, 0.0), value)
                else:
                    ledger[key] = ledger.get(key, 0.0) + value
            for (_owner, _kind, series), hist in tel.hists.items():
                prev = series_hists.get(series)
                series_hists[series] = hist if prev is None else merge_hists(prev, hist)
            pods_view[pid] = {
                "up": 1,
                "seq": tel.seq,
                "seq_lag": max_seq - tel.seq,
                "staleness_s": now - slot.ts,
                "uptime_s": tel.uptime_s,
            }
        for pid, reason in excluded:
            pods_view[pid] = {"up": 0, "reason": reason}
        with self._lock:
            self._excluded.update(pid for pid, _ in excluded)
            self._last_pods = len(members)
            self._last_degraded = len(excluded)
            self.stats.fleet_merges += 1
            self.stats.fleet_degraded_pulls += sum(
                1 for _pid, reason in excluded if reason == "stale"
            )
        for pid, reason in excluded:
            _diag.record("fleet.degraded", "fleet", pod=pid, reason=reason)
        # coverage attestation: the merged view carries its own membership
        # stamp (pods + telemetry seqs in, exclusions + reasons out) — a
        # 3/4-pod fleet number is visibly a 3/4-pod number
        coverage = _lineage.note_coverage(
            "fleet",
            members,
            seqs={pid: fresh[pid].telemetry.seq for pid in members},
            excluded=excluded,
        )
        _diag.record(
            "fleet.merge", "fleet",
            pods=len(members), degraded=len(excluded), members=",".join(members),
        )
        return {
            "pods": pods_view,
            "members": members,
            "degraded": [pid for pid, _ in excluded],
            "counters": counters,
            "reasons": {name: dict(sorted(rows.items())) for name, rows in reasons.items()},
            "sentinels": dict(sorted(sentinels.items())),
            "ledger_totals": dict(sorted(ledger.items())),
            "histograms": series_hists,
            "coverage": coverage or {},
        }

    # ------------------------------------------------------------------ SLOs

    def evaluate_slos(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Evaluate the shared SLO registry over the MERGED fleet inputs.

        The same specs the per-pod singleton evaluates, fed with the summed
        counters (aggregator-side fleet counters overlaid — a pod cannot see
        its own exclusion) and the merged per-series histograms.
        """
        merged = self.merge()
        counters = dict(merged["counters"])
        for f in ("fleet_pulls", "fleet_merges", "fleet_degraded_pulls"):
            counters[f] = counters.get(f, 0) + getattr(self.stats, f)
        hists = merged["histograms"]

        def series_fn(name: str) -> Histogram:
            return hists.get(name) or Histogram()

        return self.slo.evaluate(
            inputs={"counters": counters, "series": series_fn}, now=now
        )

    # ------------------------------------------------------------------ views

    def fleet_state(self) -> Dict[str, int]:
        """The telemetry gauge row (``serve/stats.py`` registry contract)."""
        with self._lock:
            if self._last_pods:
                return {"pods": self._last_pods, "degraded_pods": self._last_degraded}
            return {"pods": len(self._slots), "degraded_pods": len(self._excluded)}

    #: curated per-pod counter families for the fleet exposition: the hot-path
    #: health surface, not all ~70 fields — the full set rides each pod's own
    #: /metrics; the fleet view answers "which pod is sick"
    _POD_COUNTERS = (
        "dispatches", "eager_fallbacks", "sync_degraded_folds", "quarantined_batches",
    )

    def export_prometheus(self, path: Optional[str] = None) -> str:
        """Render the fleet view as Prometheus text exposition format.

        Byte-stable under pod ingest order: merges are commutative and every
        sample set renders in canonical (pod id, label) order. Pod ids are
        caller-supplied strings — every label value goes through the
        exposition escaping (backslash, double-quote, newline).
        """
        from torchmetrics_tpu_torch.diag.telemetry import _HIST_SERIES, _PREFIX, _sample

        merged = self.merge()
        slo_rows = self.slo.state()
        lines: List[str] = []

        def emit(name: str, mtype: str, help_text: str, samples) -> None:
            if not samples:
                return
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                lines.append(_sample(name, labels, value))

        pods_view = merged["pods"]
        emit(f"{_PREFIX}_fleet_pods", "gauge",
             "pods with fresh verified telemetry in the fleet membership",
             [({}, len(merged["members"]))])
        emit(f"{_PREFIX}_fleet_degraded_pods", "gauge",
             "pods excluded from the last fleet merge (stale/unreachable)",
             [({}, len(merged["degraded"]))])
        emit(f"{_PREFIX}_fleet_pod_up", "gauge",
             "1 when the pod's telemetry is in the fresh membership",
             [({"pod": pid}, row["up"]) for pid, row in sorted(pods_view.items())])
        fresh_rows = [(pid, row) for pid, row in sorted(pods_view.items()) if row["up"]]
        emit(f"{_PREFIX}_fleet_pod_seq", "gauge",
             "the pod's last verified telemetry sequence watermark",
             [({"pod": pid}, row["seq"]) for pid, row in fresh_rows])
        emit(f"{_PREFIX}_fleet_pod_seq_lag", "gauge",
             "sequence distance behind the most-advanced fleet member",
             [({"pod": pid}, row["seq_lag"]) for pid, row in fresh_rows])
        emit(f"{_PREFIX}_fleet_pod_staleness_seconds", "gauge",
             "age of the pod's last verified telemetry at merge time",
             [({"pod": pid}, row["staleness_s"]) for pid, row in fresh_rows])
        emit(f"{_PREFIX}_fleet_pod_uptime_seconds", "gauge",
             "the pod's self-reported process uptime",
             [({"pod": pid}, row["uptime_s"]) for pid, row in fresh_rows])

        # per-pod curated counters (pod-labeled) + the fleet-wide sums
        fresh, members, _ = self._fresh_membership()
        for field in self._POD_COUNTERS:
            emit(f"{_PREFIX}_{field}_total", "counter",
                 f"per-pod {field.replace('_', ' ')} (fleet view)",
                 [({"pod": pid}, fresh[pid].telemetry.counters.get(field, 0))
                  for pid in members])
            emit(f"{_PREFIX}_fleet_{field}_total", "counter",
                 f"fleet-wide {field.replace('_', ' ')} (summed over fresh pods)",
                 [({}, merged["counters"].get(field, 0))])

        emit(f"{_PREFIX}_sentinel_flags", "gauge",
             "fleet-ORed health-sentinel bitmask per metric (0 = healthy)",
             [({"owner": owner}, flags)
              for owner, flags in sorted(merged["sentinels"].items())])

        # merged distributions as PROPER histogram exposition under
        # tm_tpu_fleet_* names (the unit suffix stays terminal)
        for series, (name, scale, help_text) in sorted(
            _HIST_SERIES.items(), key=lambda kv: kv[1][0]
        ):
            hist = merged["histograms"].get(series)
            if hist is None or not hist.total:
                continue
            family = f"{_PREFIX}_fleet_{name}"
            lines.append(f"# HELP {family} fleet-merged {help_text}")
            lines.append(f"# TYPE {family} histogram")
            for bound, cum in hist.nonempty_buckets():
                le = "+Inf" if bound is None else repr(bound * scale)
                lines.append(_sample(f"{family}_bucket", {"le": le}, cum))
            lines.append(_sample(f"{family}_sum", {}, hist.sum * scale))
            lines.append(_sample(f"{family}_count", {}, hist.total))

        emit(f"{_PREFIX}_slo_compliance", "gauge",
             "1 when the fleet-evaluated SLO is compliant, 0 in breach",
             [({"slo": row["id"]}, 0 if row["breaching"] else 1) for row in slo_rows])
        emit(f"{_PREFIX}_slo_breaching", "gauge",
             "1 when the fleet-evaluated SLO is in breach (blocking SLOs gate /healthz)",
             [({"slo": row["id"]}, 1 if row["breaching"] else 0) for row in slo_rows])

        text = "\n".join(lines) + "\n" if lines else ""
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text
