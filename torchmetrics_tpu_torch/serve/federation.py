"""Federated multi-pod aggregation (counterpart of ``torchmetrics_tpu/serve/federation.py``).

A fleet-level question ("the global accuracy / p99 / distinct users across every
serving pod") needs the cross-rank fold of the epoch engine lifted one tier up:

- **Envelope** (:func:`pack_envelope` / :func:`parse_envelope`): one pod's metric
  states as a self-verifying ``.npz`` payload: a layout-version stamp, an
  order-independent payload CRC, a monotonic snapshot sequence number (the
  update-count watermark), list-state layout metadata and the compensated residuals.
  The framing is the JAX package's, key for key, so a port envelope parses in the
  JAX package and a JAX envelope in the port. It is built on
  :func:`~torchmetrics_tpu_torch.serve.snapshot.take_snapshot`, so producing it never
  pauses the pod's update loop. A version or CRC mismatch raises the typed
  elastic-snapshot errors.
- **Aggregator** (:class:`FederationAggregator`): takes envelopes by push
  (:meth:`~FederationAggregator.ingest`) or pulls them from pod sidecars' ``/state``
  (:meth:`~FederationAggregator.pull_round`, each fetch under
  :func:`~torchmetrics_tpu_torch.parallel.resilience.bounded_pull`). The global value
  folds the latest verified snapshot of each pod: a returning pod replaces its slot,
  and a stale sequence number is rejected at the watermark (``federation.stale``).
- **Fold**: the packed-sync plan, reused: a
  :class:`~torchmetrics_tpu_torch.parallel.packing.PackedSyncPlan` over template
  clones maps each pod to a "rank", ``pack_from`` packs each snapshot into the
  per-(role, dtype) buffers on the template's device, and one ``make_fold`` function,
  cached per (membership, plan signature), folds the stacked buffers. Every role keeps
  its cross-rank meaning: sum / mean / max / min / cat, HLL register max, the
  heavy-hitter joint fold, the compensated two-sum pairs. Pods fold in canonical
  pod-id order, so the result is byte-stable whatever the arrival order.
- **Degraded folds**: a pod that is unreachable, never ingested or past the staleness
  bound is excluded, counted and evented (``federation.degraded``), and the fold still
  answers over who is left, with a coverage stamp (``last_coverage``).
"""

from __future__ import annotations

import io
import json
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.parallel.elastic import SnapshotIntegrityError, SnapshotVersionError
from torchmetrics_tpu_torch.parallel.resilience import (
    SyncFaultError,
    bounded_pull,
    resilience_context,
)
from torchmetrics_tpu_torch.serve import stats as _serve_stats
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "FEDERATION_LAYOUT_VERSION",
    "FederationAggregator",
    "PodEnvelope",
    "pack_envelope",
    "parse_envelope",
]

#: envelope layout version — bumped on any change to the key scheme, the meta
#: JSON layout, or the CRC coverage. A mismatched version is a typed refusal
#: (:class:`~torchmetrics_tpu_torch.parallel.elastic.SnapshotVersionError`), never a
#: guess at the layout.
FEDERATION_LAYOUT_VERSION = 1

#: HTTP header names the sidecar ``/state`` endpoint stamps (and the
#: aggregator cross-checks against the payload's own stamps)
VERSION_HEADER = "X-TM-Layout-Version"
CRC_HEADER = "X-TM-Payload-CRC"
SEQ_HEADER = "X-TM-Snapshot-Seq"

_RES_MARK = "__res__"  # key segment marking a compensated-sum residual entry


def _payload_crc(flat: Mapping[str, np.ndarray]) -> int:
    """Order-independent digest over every payload entry (elastic-shard style).

    Everything except the ``__crc__`` stamp itself is covered — including the
    ``__meta__`` layout JSON, the version, and the sequence number, so a
    tampered watermark or list layout is as loud as tampered state bytes.
    """
    crc = 0
    for key in sorted(flat):
        if key == "__crc__":
            continue
        arr = np.ascontiguousarray(flat[key])
        header = f"{key}|{arr.dtype}|{arr.shape}|".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(header, crc))
    return crc & 0xFFFFFFFF


@dataclass
class PodEnvelope:
    """One pod's verified snapshot, parsed back into fold-ready form."""

    states: Dict[str, Dict[str, Any]]  # {owner: {attr: array-or-list}}
    residuals: Dict[str, Dict[str, Any]]  # {owner: {attr: residual array}}
    seq: int  # monotonic snapshot sequence (update-count watermark)
    update_counts: Dict[str, int] = field(default_factory=dict)


def _host(value: Any) -> np.ndarray:
    """A state tensor (or an already-host value) as a numpy array."""
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _as_metric_map(target: Any) -> Dict[str, Any]:
    from torchmetrics_tpu_torch.metric import Metric

    if isinstance(target, Metric):
        return {"metric": target}
    return dict(target)


def pack_envelope(metrics: Any, seq: Optional[int] = None) -> Tuple[bytes, Dict[str, str]]:
    """Serialize one pod's metric states into a self-verifying envelope.

    ``metrics`` is a Metric or an ``{owner: Metric}`` dict (owner keys must
    match the aggregator's template keys). Each metric is snapshotted with
    :func:`~torchmetrics_tpu_torch.serve.snapshot.take_snapshot` — the pause-free
    consistency protocol — so the envelope is always a watermark-consistent
    cut, produced while the pod's update loop keeps dispatching.

    Returns ``(payload_bytes, headers)`` where ``headers`` carries the
    version/CRC/seq stamps for the HTTP ``/state`` surface. ``seq`` defaults
    to the summed update counts — monotonic per pod, which is all the
    aggregator's watermark dedupe needs.
    """
    from torchmetrics_tpu_torch.engine import numerics
    from torchmetrics_tpu_torch.serve.snapshot import take_snapshot

    metric_map = _as_metric_map(metrics)
    flat: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"owners": {}}
    total_updates = 0
    provenance_rows = []
    for owner in sorted(metric_map):
        snap = take_snapshot(metric_map[owner])
        total_updates += snap.update_count
        if snap.provenance:
            provenance_rows.append(snap.provenance)
        attrs_meta: Dict[str, Any] = {}
        # the npz write below is the actual device->host materialization of
        # the snapshot copies — the sanctioned aggregation-tier boundary
        with transfer_allowed("federation-ingest"):
            for attr, value in snap.state.items():
                if isinstance(value, list):
                    attrs_meta[attr] = {"list": True, "n": len(value)}
                    for i, elem in enumerate(value):
                        flat[f"{owner}::{attr}::{i}"] = _host(elem)
                else:
                    attrs_meta[attr] = {"list": False, "n": 1}
                    flat[f"{owner}::{attr}"] = _host(value)
            residuals = snap.extras.get(numerics.ATTR) or {}
            for attr, res in residuals.items():
                flat[f"{owner}::{_RES_MARK}::{attr}"] = _host(res)
        meta["owners"][owner] = {
            "attrs": attrs_meta,
            "update_count": snap.update_count,
            "residuals": sorted(residuals),
        }
    seq = total_updates if seq is None else int(seq)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
    ).copy()
    flat["__federation_version__"] = np.int64(FEDERATION_LAYOUT_VERSION)
    flat["__seq__"] = np.int64(seq)
    crc = _payload_crc(flat)
    flat["__crc__"] = np.uint32(crc)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    headers = {
        VERSION_HEADER: str(FEDERATION_LAYOUT_VERSION),
        CRC_HEADER: f"{crc:#010x}",
        SEQ_HEADER: str(seq),
    }
    if provenance_rows:
        # per-owner watermarks ride the envelope out-of-band: an aggregator
        # (or a human with curl -I) can audit what the payload covers without
        # parsing the npz
        headers[_lineage.LINEAGE_HEADER] = _lineage.encode_lineage_header(provenance_rows)
    return buf.getvalue(), headers


def parse_envelope(data: bytes, headers: Optional[Mapping[str, str]] = None) -> PodEnvelope:
    """Verify an envelope (version, CRC, header cross-check) and parse it.

    Refuses to guess: unreadable payloads and CRC mismatches raise
    :class:`~torchmetrics_tpu_torch.parallel.elastic.SnapshotIntegrityError`, a
    layout-version mismatch raises
    :class:`~torchmetrics_tpu_torch.parallel.elastic.SnapshotVersionError` — the
    same typed contract the elastic restore path enforces on disk shards.
    """
    if headers:
        raw_version = headers.get(VERSION_HEADER)
        if raw_version is not None and int(raw_version) != FEDERATION_LAYOUT_VERSION:
            raise SnapshotVersionError(
                f"pod snapshot advertises layout version {raw_version}, this build reads"
                f" {FEDERATION_LAYOUT_VERSION} — refusing to guess at the layout"
            )
    try:
        with np.load(io.BytesIO(data), allow_pickle=False) as npz:
            flat = {k: np.asarray(npz[k]) for k in npz.files}
    except Exception as err:  # noqa: BLE001 — unreadable IS the corruption signal
        raise SnapshotIntegrityError(f"pod snapshot payload is unreadable: {err}") from err
    for key in ("__federation_version__", "__seq__", "__crc__", "__meta__"):
        if key not in flat:
            raise SnapshotIntegrityError(
                f"pod snapshot payload lacks the {key} stamp — not a federation envelope"
            )
    version = int(flat["__federation_version__"])
    if version != FEDERATION_LAYOUT_VERSION:
        raise SnapshotVersionError(
            f"pod snapshot has layout version {version}, this build reads"
            f" {FEDERATION_LAYOUT_VERSION} — refusing to guess at the layout"
        )
    expected = int(flat["__crc__"])
    actual = _payload_crc(flat)
    if actual != expected:
        raise SnapshotIntegrityError(
            f"pod snapshot failed its integrity check (crc {actual:#010x} !="
            f" stamped {expected:#010x}) — the payload is corrupt"
        )
    if headers:
        raw_crc = headers.get(CRC_HEADER)
        if raw_crc is not None and int(raw_crc, 0) != expected:
            raise SnapshotIntegrityError(
                f"pod snapshot header CRC {raw_crc} disagrees with the payload stamp"
                f" {expected:#010x} — the transport delivered a different payload"
            )
    meta = json.loads(bytes(flat["__meta__"]).decode())
    states: Dict[str, Dict[str, Any]] = {}
    residuals: Dict[str, Dict[str, Any]] = {}
    update_counts: Dict[str, int] = {}
    for owner, owner_meta in meta["owners"].items():
        owner_states: Dict[str, Any] = {}
        for attr, attr_meta in owner_meta["attrs"].items():
            if attr_meta["list"]:
                owner_states[attr] = [
                    flat[f"{owner}::{attr}::{i}"] for i in range(attr_meta["n"])
                ]
            else:
                owner_states[attr] = flat[f"{owner}::{attr}"]
        states[owner] = owner_states
        if owner_meta["residuals"]:
            residuals[owner] = {
                attr: flat[f"{owner}::{_RES_MARK}::{attr}"]
                for attr in owner_meta["residuals"]
            }
        update_counts[owner] = int(owner_meta["update_count"])
    return PodEnvelope(
        states=states,
        residuals=residuals,
        seq=int(flat["__seq__"]),
        update_counts=update_counts,
    )


@dataclass
class _PodSlot:
    """The latest verified snapshot held for one pod."""

    envelope: PodEnvelope
    ts: float  # time.monotonic() at ingest — drives the staleness watermark


def _http_fetcher(url: str, timeout_s: Optional[float]) -> Callable[[], Tuple[bytes, Dict[str, str]]]:
    def fetch() -> Tuple[bytes, Dict[str, str]]:
        import urllib.request

        with urllib.request.urlopen(url, timeout=timeout_s or 10.0) as resp:
            return resp.read(), dict(resp.headers.items())

    return fetch


class FederationAggregator:
    """Fold N pods' verified snapshots into one global metric plane.

    Args:
        template: a Metric or ``{owner: Metric}`` dict DEFINING the states to
            federate — the same definitions every pod runs. The template's own
            state is never read; per-fold clones carry the pod snapshots.
        pods: ``{pod_id: source}`` where source is a ``/state`` URL (string)
            or a zero-arg callable returning ``bytes`` or ``(bytes, headers)``
            — callables let tests emulate pods without sockets.
        staleness_s: snapshots older than this (since ingest) are excluded
            from folds as degraded members. Default:
            ``TORCHMETRICS_TPU_FEDERATION_STALENESS_S`` (unset = no bound).
        timeout_ms: per-pull deadline for :meth:`pull_round`. Default:
            ``TORCHMETRICS_TPU_FEDERATION_TIMEOUT_MS`` (unset = no deadline).
        retries: bounded-pull retry budget. Default:
            ``TORCHMETRICS_TPU_FEDERATION_RETRIES`` (2).

    The global value is byte-stable for a fixed membership regardless of pod
    arrival order: members are canonically ordered by pod id before packing,
    and one fold function — cached per (membership, plan signature)
    — serves every fold over that membership.
    """

    def __init__(
        self,
        template: Any,
        pods: Optional[Mapping[str, Any]] = None,
        staleness_s: Optional[float] = None,
        timeout_ms: Optional[float] = None,
        retries: Optional[int] = None,
    ) -> None:
        from torchmetrics_tpu_torch.parallel.resilience import _env_float

        self.template = _as_metric_map(template)
        if not self.template:
            raise TorchMetricsUserError(
                "FederationAggregator needs at least one template metric — an empty"
                " template has no states to federate."
            )
        self.pods: Dict[str, Any] = dict(pods or {})
        self.staleness_s = (
            _env_float("TORCHMETRICS_TPU_FEDERATION_STALENESS_S")
            if staleness_s is None
            else float(staleness_s)
        )
        self.timeout_ms = (
            _env_float("TORCHMETRICS_TPU_FEDERATION_TIMEOUT_MS")
            if timeout_ms is None
            else float(timeout_ms)
        )
        self.retries = _serve_stats.federation_retries() if retries is None else int(retries)
        self.stats = EngineStats("federation")
        self._lock = threading.Lock()
        self._slots: Dict[str, _PodSlot] = {}  # guarded-by: _lock
        self._watermarks: Dict[str, int] = {}  # guarded-by: _lock
        self._excluded: set = set()  # guarded-by: _lock — pods out of the last fold
        self._last_pods = 0  # guarded-by: _lock — membership of the last fold
        self._last_degraded = 0  # guarded-by: _lock
        self._fold_cache: Dict[Tuple, Any] = {}  # guarded-by: _lock — fold functions
        self._scratch: Dict[str, Any] = {}  # guarded-by: _lock — compute clones
        #: coverage stamp of the last fold (diag/lineage.py ``note_coverage``
        #: form) — who the global value includes, who it excludes, and why
        self.last_coverage: Optional[Dict[str, Any]] = None
        _serve_stats.register_federation(self)

    # ------------------------------------------------------------------ ingest

    def ingest(self, pod_id: str, data: bytes, headers: Optional[Mapping[str, str]] = None) -> bool:
        """Verify and accept one pod envelope (push path).

        Returns True when the snapshot advanced the pod's watermark; False
        when the watermark dedupe rejected it as stale (a replayed or
        out-of-order snapshot — counted, evented, never folded twice).
        """
        envelope = parse_envelope(data, headers)
        missing = sorted(set(self.template) - set(envelope.states))
        if missing:
            # folding an absent owner would silently poison the global value —
            # a definition mismatch between pod and aggregator is a user error
            raise TorchMetricsUserError(
                f"pod {pod_id!r} snapshot lacks states for template owner(s)"
                f" {missing} (envelope holds {sorted(envelope.states)}) — the pod"
                " and the aggregator must run the same metric definitions under"
                " the same owner keys."
            )
        with self._lock:
            prev = self._watermarks.get(pod_id)
            if prev is not None and envelope.seq <= prev:
                self.stats.federation_stale_skips += 1
                _diag.record(
                    "federation.stale", "federation",
                    pod=pod_id, seq=envelope.seq, watermark=prev,
                )
                return False
            rejoined = pod_id in self._excluded
            self._excluded.discard(pod_id)
            self._slots[pod_id] = _PodSlot(envelope=envelope, ts=time.monotonic())
            self._watermarks[pod_id] = envelope.seq
            self.stats.federation_ingests += 1
        if rejoined:
            # the pod REPLACES its slot, so re-admission cannot double-count —
            # but it is a membership change worth narrating
            _diag.record("federation.rejoin", "federation", pod=pod_id, seq=envelope.seq)
        _diag.record(
            "federation.ingest", "federation",
            pod=pod_id, seq=envelope.seq, bytes=len(data),
        )
        return True

    def pull_round(self) -> Dict[str, bool]:
        """Pull every configured pod's ``/state`` once (bounded, classified).

        Each fetch runs through :func:`~torchmetrics_tpu_torch.parallel.resilience.
        bounded_pull` — deadline watchdog, retry/backoff, typed fault
        classification, and the fault-injection hook (pod-churn chaos tests
        plant at this exact boundary). A pod whose pull terminally fails is
        excluded (``federation.degraded``) until it is ingested again; the
        round never raises for a single lost pod.

        Returns ``{pod_id: ingested}`` (False = unreachable or stale).
        """
        pod_ids = sorted(self.pods)
        member_idx = {pid: i for i, pid in enumerate(pod_ids)}
        results: Dict[str, bool] = {}
        timeout_s = self.timeout_ms / 1e3 if self.timeout_ms else None
        with resilience_context(deadline_ms=self.timeout_ms, retries=self.retries):
            for pid in pod_ids:
                source = self.pods[pid]
                fetch = source if callable(source) else _http_fetcher(source, timeout_s)
                try:
                    out = bounded_pull(
                        fetch,
                        label=f"federation-pull:{pid}",
                        rank=member_idx[pid],
                        # a pull involves ONLY its target pod — rank-scoped
                        # fault injection (pod-churn chaos) hits exactly that
                        # pod's fetch, not the whole round
                        members=[member_idx[pid]],
                    )
                except SyncFaultError as exc:
                    with self._lock:
                        self._excluded.add(pid)
                    _diag.record(
                        "federation.degraded", "federation",
                        pod=pid, reason=type(exc).__name__, attempts=exc.attempts,
                    )
                    results[pid] = False
                    continue
                data, headers = out if isinstance(out, tuple) else (out, None)
                results[pid] = self.ingest(pid, data, headers)
        return results

    # ------------------------------------------------------------------ fold

    def _fresh_membership(self) -> Tuple[Dict[str, _PodSlot], List[str], List[Tuple[str, str]]]:
        now = time.monotonic()
        with self._lock:
            slots = dict(self._slots)
            known = sorted(set(self.pods) | set(slots))
        fresh: Dict[str, _PodSlot] = {}
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

    def _build_plan(self, members: List[str], fresh: Dict[str, _PodSlot]) -> Any:
        from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

        # representative snapshot for the plan skeleton: list-typed states
        # (cat lists) must be NONEMPTY on the building "rank" for their
        # element dtype — hence the buffer layout — to be knowable, so prefer
        # the pod holding the most populated lists (deterministic tie-break by
        # canonical order)
        def _list_score(pid: str) -> int:
            return sum(
                1
                for owner_states in fresh[pid].envelope.states.values()
                for value in owner_states.values()
                if isinstance(value, list) and value
            )

        rep = max(members, key=lambda pid: (_list_score(pid), -members.index(pid)))
        rep_states = fresh[rep].envelope.states
        clones: List[Tuple[str, Any]] = []
        for owner in sorted(self.template):
            clone = self.template[owner].clone()
            clone.sync_on_compute = False
            clone._to_sync = False
            clone.compute_with_cache = False
            for attr, value in rep_states.get(owner, {}).items():
                if attr in clone._defaults:
                    staged = (
                        [torch.as_tensor(e, device=clone.device) for e in value]
                        if isinstance(value, list)
                        else torch.as_tensor(value, device=clone.device)
                    )
                    object.__setattr__(clone, attr, staged)
            clones.append((owner, clone))
        plan = PackedSyncPlan(clones, world_size=len(members))
        # the aggregation tier disables the metadata riders: there is no
        # cross-rank barrier to timestamp and the divergence audit's
        # rank-invariance contract does not apply to independent pods
        plan.audit = False
        plan.timeline = False
        metas = [plan.metadata_from_state(fresh[pid].envelope.states) for pid in members]
        world_meta = None if metas[0] is None else np.stack(metas)
        plan.finalize(world_meta)
        return plan

    def fold(self) -> Dict[str, Dict[str, Any]]:
        """One global fold over the fresh membership → ``{owner: {attr: value}}``.

        Degraded is a first-class outcome: excluded pods (stale, unreachable,
        never ingested) are dropped from the membership, counted, and evented
        — the fold still answers over who is left. No verified snapshot at
        all raises :class:`~torchmetrics_tpu_torch.utilities.exceptions.
        TorchMetricsUserError` (nothing to answer with is an error, not a 0).
        """
        fresh, members, excluded = self._fresh_membership()
        if not members:
            raise TorchMetricsUserError(
                "Federation fold has no verified pod snapshot to fold — ingest or"
                " pull at least one pod before asking for a global value."
            )
        plan = self._build_plan(members, fresh)
        # envelope arrays are host numpy, staged into the fold's buffers on the card
        packed = [plan.pack_from(fresh[pid].envelope.states, fresh[pid].envelope.residuals) for pid in members]
        gathered = {k: torch.stack([p[k] for p in packed]) for k in packed[0]}
        cache_key = (tuple(members), plan.signature())
        with self._lock:
            fold_fn = self._fold_cache.get(cache_key)
            if fold_fn is None:
                # the pod-id tuple is part of the key: a degraded fold is never served
                # by the full membership's function, or the other way round
                fold_fn = self._fold_cache[cache_key] = plan.make_fold()
        result = fold_fn(gathered)
        with self._lock:
            self._excluded.update(pid for pid, _ in excluded)
            self._last_pods = len(members)
            self._last_degraded = len(excluded)
            self.stats.federation_folds += 1
            if excluded:
                self.stats.federation_degraded_folds += 1
        for pid, reason in excluded:
            _diag.record("federation.degraded", "federation", pod=pid, reason=reason)
        # coverage attestation: the stamp names exactly who this global value
        # folded (pod ids + their snapshot seqs) and who it excluded and why —
        # a degraded 3/4-pod fold is visibly a 3/4-pod value, never a silent 4/4
        stamp = _lineage.note_coverage(
            "federation",
            members,
            seqs={pid: fresh[pid].envelope.seq for pid in members},
            excluded=excluded,
        )
        self.last_coverage = stamp
        _diag.record(
            "federation.fold", "federation",
            pods=len(members), degraded=len(excluded), members=",".join(members),
        )
        return result

    def compute_global(self) -> Any:
        """Fold, then ``compute()`` each owner on its scratch clone.

        Returns the single value for a single-Metric template, else
        ``{owner: value}``. The template metrics themselves are never touched
        — the folded states install into cached compute-only clones (the
        snapshot-compute discipline at the aggregation tier).
        """
        folded = self.fold()
        with self._lock:
            update_counts = {
                pid: slot.envelope.update_counts for pid, slot in self._slots.items()
            }
        values: Dict[str, Any] = {}
        for owner in sorted(self.template):
            with self._lock:
                scratch = self._scratch.get(owner)
                if scratch is None:
                    scratch = self.template[owner].clone()
                    scratch.sync_on_compute = False
                    scratch._to_sync = False
                    scratch.compute_with_cache = False
                    self._scratch[owner] = scratch
            total_updates = sum(c.get(owner, 0) for c in update_counts.values())
            prior = dict(scratch.__dict__)
            try:
                for attr, value in folded.get(owner, {}).items():
                    if attr in scratch._defaults:
                        object.__setattr__(scratch, attr, value)
                object.__setattr__(scratch, "_update_count", max(total_updates, 1))
                object.__setattr__(scratch, "_computed", None)
                values[owner] = scratch._raw_compute()
            finally:
                scratch.__dict__.clear()
                scratch.__dict__.update(prior)
        return values["metric"] if set(self.template) == {"metric"} else values

    # ------------------------------------------------------------------ views

    def federation_state(self) -> Dict[str, int]:
        """The telemetry gauge row (``serve/stats.py`` registry contract)."""
        with self._lock:
            if self._last_pods:
                return {"pods": self._last_pods, "degraded_pods": self._last_degraded}
            return {"pods": len(self._slots), "degraded_pods": len(self._excluded)}

    def serve(self, port: Optional[int] = None, host: str = "127.0.0.1") -> Any:
        """Expose the global plane on a reused sidecar (started; caller stops).

        The standard :class:`~torchmetrics_tpu_torch.serve.sidecar.MetricsSidecar`
        already exports everything this aggregator registers — the federation
        gauges and counters ride the same ``/metrics`` Prometheus surface a
        pod's sidecar serves.
        """
        from torchmetrics_tpu_torch.serve.sidecar import MetricsSidecar

        return MetricsSidecar(port=port, host=host).start()
