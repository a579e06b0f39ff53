"""Telemetry exporter: the scrapeable surface over counters, ledger, sentinels
(counterpart of ``torchmetrics_tpu/diag/telemetry.py``, the same family names).

It renders what the diag subsystem knows (engine counters, retrace causes, fallback
reasons, flight-recorder event counts, the cost ledger, the sentinels, the
histograms of ``diag/hist.py`` as ``histogram`` families with ``_bucket`` / ``_sum``
/ ``_count`` and ``le`` labels under unit-suffixed names, the probe accounting and
the serving plane) as:

- :func:`telemetry_snapshot`: one JSON-serializable dict;
- :func:`export_prometheus`: Prometheus text exposition format 0.0.4;
- :func:`export_jsonl`: one JSON line per snapshot, appended.

Output is deterministically ordered, so two exports of the same state are
byte-identical.

The snapshot's ``persist`` is ``engine/persist.persist_state()``, and the
``tm_tpu_persist_*`` families export its counters under the JAX names (a graph is never
stored or loaded, so stores, stored bytes and deserialize seconds stay 0). Kept
divergences: the ``tm_tpu_build_info`` labels name ``torch``, ``cuda`` and the card's
name where the JAX package names ``jax`` and ``jaxlib``; ``mesh`` names the active state
mesh's axes (``parallel/sharding.py``).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.diag.trace import FlightRecorder, active_recorder

__all__ = [
    "UNIT_SUFFIXES",
    "UNITLESS_COUNT_FAMILIES",
    "export_jsonl",
    "export_prometheus",
    "telemetry_snapshot",
]

_PREFIX = "tm_tpu"

#: the exposition naming convention (https://prometheus.io/docs/practices/naming/):
#: a series measuring a physical quantity must spell its base unit as the name
#: suffix.
UNIT_SUFFIXES = ("_seconds", "_bytes", "_flops", "_ratio")

#: families whose value is a pure event or object count, or an enum bitmask: no unit
#: suffix (``http_requests_total`` style). Keyed without the ``_total`` suffix.
UNITLESS_COUNT_FAMILIES = frozenset({
    "tm_tpu_traces", "tm_tpu_cache_hits", "tm_tpu_dispatches", "tm_tpu_metrics_updated",
    "tm_tpu_eager_fallbacks", "tm_tpu_donated_dispatches", "tm_tpu_donation_copies",
    "tm_tpu_donation_fallbacks", "tm_tpu_bucketed_steps", "tm_tpu_bucket_pad_rows",
    "tm_tpu_packed_syncs", "tm_tpu_sync_collectives", "tm_tpu_sync_metadata_gathers",
    "tm_tpu_sync_fold_traces", "tm_tpu_sync_divergence_flags", "tm_tpu_sync_straggler_flags",
    "tm_tpu_sync_retries", "tm_tpu_sync_degraded_folds",
    "tm_tpu_quarantined_batches", "tm_tpu_ladder_retries",
    "tm_tpu_compensated_steps", "tm_tpu_reanchors", "tm_tpu_drift_probes",
    "tm_tpu_drift_flags",
    "tm_tpu_scan_dispatches", "tm_tpu_scan_steps_folded", "tm_tpu_scan_pad_steps",
    "tm_tpu_scan_flushes", "tm_tpu_scan_flush_reasons",
    "tm_tpu_compute_traces", "tm_tpu_compute_dispatches", "tm_tpu_compute_cache_hits",
    "tm_tpu_profile_probes", "tm_tpu_engines", "tm_tpu_retrace_causes",
    "tm_tpu_fallback_reasons", "tm_tpu_events", "tm_tpu_events_dropped",
    "tm_tpu_ledger_executables", "tm_tpu_sentinel_flags",
    # serving layer: scrape/snapshot counts and the live-object gauges (the scrape
    # latency itself is unit-suffixed: serve_scrape_latency_seconds)
    "tm_tpu_serve_scrapes", "tm_tpu_serve_snapshots", "tm_tpu_serve_snapshot_retries",
    "tm_tpu_serve_tenants", "tm_tpu_serve_spilled_updates",
    "tm_tpu_spec_fallbacks",
    "tm_tpu_fid_host_eighs", "tm_tpu_map_host_evals",
    "tm_tpu_shard_states", "tm_tpu_psum_syncs", "tm_tpu_gather_skipped",
    "tm_tpu_shard_degrades", "tm_tpu_ingraph_syncs", "tm_tpu_sync_noop_plans",
    "tm_tpu_async_submits", "tm_tpu_async_dispatches", "tm_tpu_async_joins",
    "tm_tpu_async_backpressure_waits", "tm_tpu_async_replayed_steps",
    "tm_tpu_async_prefetches", "tm_tpu_async_queue_depth",
    "tm_tpu_persist_hits", "tm_tpu_persist_misses", "tm_tpu_prewarm_replays",
    "tm_tpu_persist_stores", "tm_tpu_persist_envelope_rejects",
    "tm_tpu_persist_corrupt_skips", "tm_tpu_persist_fallbacks",
    "tm_tpu_persist_manifest_entries",
    "tm_tpu_federation_ingests", "tm_tpu_federation_folds",
    "tm_tpu_federation_degraded_folds", "tm_tpu_federation_stale_skips",
    "tm_tpu_federation_pods", "tm_tpu_federation_degraded_pods",
    "tm_tpu_fleet_pulls", "tm_tpu_fleet_merges", "tm_tpu_fleet_degraded_pulls",
    "tm_tpu_fleet_pods", "tm_tpu_fleet_degraded_pods", "tm_tpu_fleet_pod_up",
    "tm_tpu_fleet_pod_seq", "tm_tpu_fleet_pod_seq_lag",
    "tm_tpu_fleet_dispatches", "tm_tpu_fleet_eager_fallbacks",
    "tm_tpu_fleet_sync_degraded_folds", "tm_tpu_fleet_quarantined_batches",
    "tm_tpu_slo_evaluations", "tm_tpu_slo_breaches", "tm_tpu_slo_recoveries",
    "tm_tpu_slo_compliance", "tm_tpu_slo_breaching",
    "tm_tpu_lineage_records", "tm_tpu_lineage_spans",
    "tm_tpu_lineage_coverage_folds", "tm_tpu_staleness_steps",
    # the port's CUDA graph counters: captures and their replays
    "tm_tpu_captures", "tm_tpu_replays",
    # build-identity info gauge: constant 1, all content in the labels
    "tm_tpu_build_info",
})

# EngineStats fields exported as monotonic counters (everything countable);
# HELP strings double as the field glossary for scrape-side dashboards.
_COUNTER_HELP = {
    "traces": "update executables compiled",
    "captures": "CUDA graphs captured for update signatures",
    "replays": "CUDA graph replays of captured update signatures",
    "input_copy_bytes": "batch bytes copied into the static input buffers of captured graphs",
    "cache_hits": "update steps served by a cached executable",
    "dispatches": "compiled update executions",
    "metrics_updated": "metric-updates performed via compiled steps",
    "eager_fallbacks": "steps that fell back to the eager Python path",
    "donated_dispatches": "dispatches that donated the state pytree",
    "donation_copies": "state leaves copied pre-dispatch to shield shared buffers",
    "donation_fallbacks": "dispatches that skipped donation",
    "bucketed_steps": "steps that rode a shape bucket",
    "bucket_pad_rows": "total pad rows added across bucketed steps",
    "bytes_moved": "input+state bytes entering compiled dispatches",
    "scan_dispatches": "multi-step scan drains executed (one dispatch folding many steps)",
    "scan_steps_folded": "real update steps folded across all scan drains",
    "scan_pad_steps": "masked no-op padding steps added to fill scan K-buckets",
    "scan_flushes": "scan-queue flushes (drains + discards)",
    "async_submits": "scan buffers swapped out and handed to the background drain worker",
    "async_dispatches": "background drains executed off the caller's thread",
    "async_joins": "observation joins that waited on in-flight background work",
    "async_join_wait_us": "host time observers spent waiting at async joins",
    "async_overlap_us": "drain/sync execution overlapped with caller forward progress",
    "async_backpressure_waits": "buffer submits that blocked on the bounded in-flight window",
    "async_replayed_steps": "steps replayed on the caller after a background drain failed",
    "async_prefetches": "host arrays device_put-staged at enqueue ahead of their drain",
    "quarantined_batches": "poisoned batches skipped in-graph by the quarantine transaction",
    "ladder_retries": "dispatch failures that stepped down the fallback ladder to a smaller bucket",
    "compensated_steps": "updates whose accumulate rode the in-graph two-sum",
    "reanchors": "epoch-boundary (value, residual) folds into a clean anchor",
    "drift_probes": "sampled drift-audit reads at the sanctioned boundary",
    "drift_flags": "drift probes exceeding TORCHMETRICS_TPU_DRIFT_RTOL",
    "packed_syncs": "packed epoch syncs completed",
    "sync_collectives": "buffer collectives issued across packed syncs",
    "sync_metadata_gathers": "metadata exchanges issued",
    "sync_bytes_moved": "bytes through packed-sync collectives",
    "sync_fold_traces": "fold / fused sync-compute executables compiled",
    "sync_divergence_flags": "rank-divergent rank-invariant states flagged by the audit",
    "sync_straggler_flags": "packed syncs whose arrival skew exceeded the straggler threshold",
    "sync_retries": "bounded-collective retries spent inside packed exchanges",
    "sync_degraded_folds": "packed syncs folded over a degraded (survivor) membership",
    "compute_traces": "compute executables compiled",
    "compute_dispatches": "cached compute dispatches",
    "compute_cache_hits": "compute dispatches served without a re-trace",
    "profile_probes": "warm dispatches followed by a sampled completion probe",
    "spec_fallbacks": "state roles resolved via the deprecated string-prefix/attribute conventions",
    "fid_host_eighs": "FID Frechet computes routed to the retained host-eigh fallback",
    "map_host_evals": "mAP computes evaluated by the retained host matcher",
    "shard_states": "states placed distributed via a resolved shard rule",
    "psum_syncs": "additive sharded states whose sync lowered to in-graph psum",
    "gather_skipped": "sharded states the packed host gather skipped",
    "shard_degrades": "shard-rule resolutions degraded to replication",
    "ingraph_syncs": "packed exchanges that rode the data axis in-graph",
    "sync_noop_plans": "packed syncs skipped wholesale (every state live-sharded)",
    "persist_hits": "compiles served by deserializing a persisted executable",
    "persist_misses": "compiles with no loadable persisted artifact (absent/stale/corrupt)",
    "prewarm_replays": "manifest rows replayed by prewarm before traffic landed",
    "federation_ingests": "pod snapshots accepted by the federation aggregator",
    "federation_folds": "global federation folds executed over the verified membership",
    "federation_degraded_folds": "federation folds over a degraded (pod-excluding) membership",
    "federation_stale_skips": "pod snapshots rejected by the federation watermark/staleness dedupe",
    "fleet_pulls": "pod telemetry envelopes accepted by the fleet aggregator",
    "fleet_merges": "fleet-wide telemetry merges over the fresh pod membership",
    "fleet_degraded_pulls": "pods excluded from a fleet pull/merge round (fault, stale, never pulled)",
    "slo_evaluations": "SLO evaluation passes over the registered objectives",
    "slo_breaches": "SLO compliance transitions into breach",
    "slo_recoveries": "SLO compliance transitions back to healthy",
    "lineage_records": "ValueProvenance records built at observation sites",
    "lineage_spans": "causal lineage spans opened at enqueue (one per drain generation)",
    "lineage_coverage_folds": "coverage attestations stamped at fold/merge sites",
}

# exposition-convention names for counters whose field name buries the unit:
# per https://prometheus.io/docs/practices/naming/ the base unit is the name
# SUFFIX (before _total), so `bytes_moved` exports as `moved_bytes`
_COUNTER_EXPORT_NAME = {
    "bytes_moved": "moved_bytes",
    "sync_bytes_moved": "sync_moved_bytes",
}

# µs-valued counters export in SECONDS under a unit-suffixed name (the
# exposition base-unit rule); the in-repo EngineStats fields stay integral µs
_COUNTER_EXPORT_SCALE = {
    "async_join_wait_us": ("async_join_wait_seconds", 1e-6),
    "async_overlap_us": ("async_overlap_seconds", 1e-6),
}

# histogram series (diag/hist.py, recorded in µs / bytes) -> exposition
# family name + value scale. Latencies export in SECONDS, sizes in BYTES —
# unit-suffixed per the exposition conventions (the test parser rejects
# unitless new series).
_HIST_SERIES = {
    "dispatch_us": ("dispatch_latency_seconds", 1e-6, "host wall-time of the async dispatch launch"),
    "device_us": ("device_latency_seconds", 1e-6, "sampled dispatch-to-completion latency (profiling probes)"),
    "sync_us": ("sync_latency_seconds", 1e-6, "packed-sync exchange wall-time"),
    "compute_us": ("compute_latency_seconds", 1e-6, "cached/fused compute dispatch wall-time"),
    "sync_bytes": ("sync_size_bytes", 1.0, "bytes through packed-sync collectives per exchange"),
    "scrape_us": ("serve_scrape_latency_seconds", 1e-6, "sidecar scrape handling wall-time"),
    # async dispatch (engine/async_dispatch.py): per-enqueue caller cost and
    # the in-flight buffer depth behind the background worker (a pure count —
    # allowlisted unitless, like the scan step counters)
    "enqueue_us": ("async_enqueue_latency_seconds", 1e-6, "caller-side cost of one async scan enqueue"),
    "depth": ("async_queue_depth", 1.0, "in-flight buffers pending behind the background drain worker"),
    # value provenance & freshness plane (diag/lineage.py): per-observation
    # staleness bounds. Steps-behind is a pure count (allowlisted unitless,
    # like the queue depth); the wall bound exports in seconds.
    "staleness_steps": ("staleness_steps", 1.0, "enqueued-but-unfolded steps behind at observation time"),
    "staleness_us": ("staleness_seconds", 1e-6, "wall-clock bound on observed-value age (oldest unfolded enqueue)"),
}


def _escape(value: Any) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(value: Any) -> str:
    """Full-precision sample rendering: ``%g`` would truncate byte/flops
    counters past 6 significant digits, silently corrupting scraped rates."""
    number = float(value)
    if number.is_integer() and abs(number) < 2**63:
        return str(int(number))
    return repr(number)


def _sample(name: str, labels: Dict[str, Any], value: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


def telemetry_snapshot(recorder: Optional[FlightRecorder] = None) -> Dict[str, Any]:
    """One merged observability dict: counters + events + ledger + sentinels.

    ``recorder`` defaults to the active flight recorder (event counts are
    empty when recording is off). Purely a read — nothing is reset.
    """
    from torchmetrics_tpu_torch.diag.costs import ledger_snapshot
    from torchmetrics_tpu_torch.diag.hist import histograms_snapshot
    from torchmetrics_tpu_torch.diag.lineage import lineage_snapshot
    from torchmetrics_tpu_torch.diag.profile import profile_snapshot
    from torchmetrics_tpu_torch.diag.sentinel import sentinel_report
    from torchmetrics_tpu_torch.diag.slo import slo_state
    from torchmetrics_tpu_torch.engine.persist import persist_state
    from torchmetrics_tpu_torch.engine.stats import engine_report
    from torchmetrics_tpu_torch.parallel.resilience import resilience_snapshot

    from torchmetrics_tpu_torch.serve.stats import serve_state

    rec = recorder if recorder is not None else active_recorder()
    counters = engine_report()
    return {
        "counters": counters,
        "events": dict(sorted(rec.counts.items())) if rec is not None else {},
        "dropped": rec.dropped if rec is not None else 0,
        "ledger": ledger_snapshot(),
        "sentinels": sentinel_report(),
        "histograms": histograms_snapshot(),
        "profile": profile_snapshot(),
        "resilience": resilience_snapshot(),
        "serve": serve_state(),
        "persist": persist_state(),
        "slo": slo_state(),
        "provenance": lineage_snapshot(),
    }


def _build_info_labels() -> Dict[str, str]:
    """Label set for the ``tm_tpu_build_info`` gauge (value is always 1): the package
    version, torch and its CUDA version, the backend, the card's name and count, and
    the active state mesh's shape (``parallel/sharding.py``; empty with none). Label
    values are escaped by
    :func:`_sample`; a function of its own so tests can monkeypatch hostile values."""
    import torch

    from torchmetrics_tpu_torch.__about__ import __version__
    from torchmetrics_tpu_torch.parallel.sharding import metric_mesh

    cuda = torch.cuda.is_available()
    mesh = metric_mesh()
    return {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "",
        "device_count": str(torch.cuda.device_count() if cuda else 0),
        "mesh": "" if mesh is None else ",".join(f"{axis}={size}" for axis, size in mesh.shape.items()),
    }


def export_prometheus(path: Optional[str] = None, snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Render a telemetry snapshot as Prometheus text exposition format.

    Returns the exposition text; additionally writes it to ``path`` when
    given. The output parses with any exposition-format consumer (the test
    suite round-trips it through a minimal parser).
    """
    snap = snapshot if snapshot is not None else telemetry_snapshot()
    counters = snap.get("counters", {})
    lines: List[str] = []

    def emit(name: str, mtype: str, help_text: str, samples: List[Tuple[Dict[str, Any], Any]]) -> None:
        if not samples:
            return
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            lines.append(_sample(name, labels, value))

    # build-identity join key first: constant 1, all content in the labels
    emit(f"{_PREFIX}_build_info", "gauge",
         "build/runtime identity (version, torch/cuda, backend, devices, mesh)",
         [(_build_info_labels(), 1)])
    for field in sorted(_COUNTER_HELP):
        if field in counters:
            scaled = _COUNTER_EXPORT_SCALE.get(field)
            if scaled is not None:
                name, scale = scaled
                emit(f"{_PREFIX}_{name}_total", "counter", _COUNTER_HELP[field],
                     [({}, counters[field] * scale)])
                continue
            name = _COUNTER_EXPORT_NAME.get(field, field)
            emit(f"{_PREFIX}_{name}_total", "counter", _COUNTER_HELP[field], [({}, counters[field])])
    emit(f"{_PREFIX}_engines", "gauge", "live engine instances", [({}, counters.get("engines", 0))])
    emit(
        f"{_PREFIX}_retrace_causes_total", "counter", "attributed causes of post-warmup compiles",
        [({"cause": c}, n) for c, n in sorted(counters.get("retrace_causes", {}).items())],
    )
    emit(
        f"{_PREFIX}_fallback_reasons_total", "counter", "eager fallbacks by reason",
        [({"reason": r}, n) for r, n in sorted(counters.get("fallback_reasons", {}).items())],
    )
    emit(
        f"{_PREFIX}_scan_flush_reasons_total", "counter", "multi-step scan-queue flushes by reason",
        [({"reason": r}, n) for r, n in sorted(counters.get("scan_flush_reasons", {}).items())],
    )
    emit(
        f"{_PREFIX}_events_total", "counter", "flight-recorder events by kind",
        [({"kind": k}, n) for k, n in sorted(snap.get("events", {}).items())],
    )
    emit(
        f"{_PREFIX}_events_dropped_total", "counter", "flight-recorder ring-buffer drops",
        [({}, snap.get("dropped", 0))],
    )

    ledger = snap.get("ledger", {})
    totals = ledger.get("totals", {})
    emit(f"{_PREFIX}_ledger_executables", "gauge", "compiled executables in the cost ledger",
         [({}, totals.get("executables", 0))])
    # unit-suffixed per the exposition conventions (seconds, not the ms the
    # in-repo ledger dicts carry — JSON exports keep their field names)
    emit(f"{_PREFIX}_ledger_compile_seconds_total", "counter", "compile wall-time across executables",
         [({}, totals.get("compile_ms", 0.0) / 1e3)])
    for field, export_name, help_text in (
        ("flops", "flops", "estimated flops per execution"),
        ("bytes_accessed", "accessed_bytes", "estimated bytes accessed per execution"),
        ("peak_bytes", "peak_bytes", "peak (args+outputs+temps+code) bytes of the executable"),
        ("donation_savings_bytes", "donation_savings_bytes", "state bytes the donation avoided copying"),
    ):
        emit(
            f"{_PREFIX}_ledger_{export_name}", "gauge", help_text,
            [
                ({"owner": e["owner"], "kind": e["kind"], "signature": e["signature"]}, e[field])
                for e in ledger.get("executables", [])
                if e.get(field) is not None
            ],
        )

    emit(
        f"{_PREFIX}_sentinel_flags", "gauge", "health-sentinel bitmask per metric (0 = healthy)",
        [({"owner": s["owner"]}, s["flags"]) for s in snap.get("sentinels", [])],
    )

    # serving layer (serve/): scrape + snapshot counters and the live-object
    # gauges (tenant slots in use, sketch saturation). Scrape latency exports
    # as the serve_scrape_latency_seconds histogram family below.
    serve = snap.get("serve", {})
    emit(f"{_PREFIX}_serve_scrapes_total", "counter", "sidecar scrape requests answered",
         [({}, serve.get("scrapes", 0))])
    emit(f"{_PREFIX}_serve_scrape_seconds_total", "counter", "wall-time spent answering scrapes",
         [({}, serve.get("scrape_seconds", 0.0))])
    emit(f"{_PREFIX}_serve_snapshots_total", "counter", "pause-free state snapshots taken",
         [({}, serve.get("snapshots", 0))])
    emit(f"{_PREFIX}_serve_snapshot_retries_total", "counter",
         "snapshot attempts retried for a consistent watermark",
         [({}, serve.get("snapshot_retries", 0))])
    emit(
        f"{_PREFIX}_serve_tenants", "gauge", "live tenant slots in use per slice registry",
        [({"owner": t["owner"]}, t["tenants"]) for t in serve.get("tenancies", [])],
    )
    emit(
        f"{_PREFIX}_serve_spilled_updates_total", "counter",
        "updates spilled past tenant capacity into the heavy-hitter sketch",
        [({"owner": t["owner"]}, t["spilled"]) for t in serve.get("tenancies", [])],
    )
    emit(
        f"{_PREFIX}_serve_sketch_fill_ratio", "gauge",
        "fraction of touched sketch registers/cells (saturation)",
        [({"owner": s["owner"]}, s["fill_ratio"]) for s in serve.get("sketches", [])],
    )
    # federated aggregation plane (serve/federation.py): live/degraded pod
    # gauges per aggregator. Ingest/fold/dedupe counts ride the EngineStats
    # auto-export above (federation_ingests/folds/degraded_folds/stale_skips).
    emit(
        f"{_PREFIX}_federation_pods", "gauge",
        "pods with a verified snapshot in the federation membership",
        [({"owner": f["owner"]}, f["pods"]) for f in serve.get("federations", [])],
    )
    emit(
        f"{_PREFIX}_federation_degraded_pods", "gauge",
        "pods excluded from the last federation fold (stale/unreachable)",
        [({"owner": f["owner"]}, f["degraded_pods"]) for f in serve.get("federations", [])],
    )
    # fleet observability plane (serve/fleet.py): membership gauges per
    # aggregator. Pull/merge/exclusion counts ride the EngineStats auto-export
    # above (fleet_pulls/fleet_merges/fleet_degraded_pulls); the pod-labeled
    # per-pod series and merged tm_tpu_fleet_* families render on the fleet
    # aggregator's own exposition (FleetTelemetry.export_prometheus).
    emit(
        f"{_PREFIX}_fleet_pods", "gauge",
        "pods with fresh verified telemetry in the fleet membership",
        [({"owner": f["owner"]}, f["pods"]) for f in serve.get("fleets", [])],
    )
    emit(
        f"{_PREFIX}_fleet_degraded_pods", "gauge",
        "pods excluded from the last fleet merge (stale/unreachable)",
        [({"owner": f["owner"]}, f["degraded_pods"]) for f in serve.get("fleets", [])],
    )
    # declarative SLO engine (diag/slo.py): per-SLO compliance gauges over the
    # local evaluator's last pass. Evaluation/transition counts ride the
    # EngineStats auto-export (slo_evaluations/slo_breaches/slo_recoveries).
    emit(
        f"{_PREFIX}_slo_compliance", "gauge",
        "1 when the SLO is compliant, 0 in breach",
        [({"slo": row["id"]}, 0 if row["breaching"] else 1) for row in snap.get("slo", [])],
    )
    emit(
        f"{_PREFIX}_slo_breaching", "gauge",
        "1 when the SLO is in breach (blocking SLOs gate /healthz readiness)",
        [({"slo": row["id"]}, 1 if row["breaching"] else 0) for row in snap.get("slo", [])],
    )

    # the signature manifest and its lookups (engine/persist.py): store / reject /
    # fallback counters and the deserialize wall-time, the JAX families (a graph is never
    # stored or loaded: those stay 0). Hit / miss / replay counts ride the EngineStats
    # export above (persist_hits / persist_misses / prewarm_replays).
    persist = snap.get("persist") or {}
    emit(f"{_PREFIX}_persist_stores_total", "counter",
         "executables serialized into the persistent cache",
         [({}, persist.get("stores", 0))])
    emit(f"{_PREFIX}_persist_stored_bytes_total", "counter",
         "serialized artifact bytes written to the persistent cache",
         [({}, persist.get("stored_bytes", 0))])
    emit(f"{_PREFIX}_persist_deserialize_seconds_total", "counter",
         "wall-time spent deserializing persisted executables",
         [({}, persist.get("deserialize_ms", 0.0) / 1e3)])
    emit(f"{_PREFIX}_persist_envelope_rejects_total", "counter",
         "persisted artifacts rejected for a compatibility-envelope mismatch",
         [({}, persist.get("envelope_rejects", 0))])
    emit(f"{_PREFIX}_persist_corrupt_skips_total", "counter",
         "corrupt persisted artifacts/manifest lines skipped loud",
         [({}, persist.get("corrupt_skips", 0))])
    emit(f"{_PREFIX}_persist_fallbacks_total", "counter",
         "persist-tier degradations (native-cache fallback, failed replays)",
         [({}, persist.get("fallbacks", 0))])
    emit(f"{_PREFIX}_persist_manifest_entries", "gauge",
         "prewarm-manifest rows recorded this process",
         [({}, persist.get("manifest_entries", 0))])

    # latency/size distributions as PROPER histogram exposition: cumulative
    # `_bucket` samples with `le` labels (non-empty buckets + the mandatory
    # +Inf), `_sum`, `_count`. One family per series, (owner, kind) labels.
    from torchmetrics_tpu_torch.diag.hist import histogram_items

    by_family: Dict[str, List[Tuple[Dict[str, Any], Any]]] = {}
    for (owner, kind, series), hist in histogram_items():
        family = _HIST_SERIES.get(series)
        if family is None:
            continue
        name, scale, _ = family
        labels = {"owner": owner, "kind": kind}
        rows = by_family.setdefault(name, [])
        for bound, cum in hist.nonempty_buckets():
            le = "+Inf" if bound is None else repr(bound * scale)
            rows.append(({**labels, "le": le}, ("bucket", cum)))
        rows.append((labels, ("sum", hist.sum * scale)))
        rows.append((labels, ("count", hist.total)))
    for series, (name, _, help_text) in sorted(_HIST_SERIES.items(), key=lambda kv: kv[1][0]):
        rows = by_family.get(name)
        if not rows:
            continue
        lines.append(f"# HELP {_PREFIX}_{name} {help_text}")
        lines.append(f"# TYPE {_PREFIX}_{name} histogram")
        for labels, (suffix, value) in rows:
            lines.append(_sample(f"{_PREFIX}_{name}_{suffix}", labels, value))

    text = "\n".join(lines) + "\n" if lines else ""
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def export_jsonl(path: str, snapshot: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Append one snapshot as a single JSON line; returns the snapshot."""
    snap = snapshot if snapshot is not None else telemetry_snapshot()
    with open(path, "a") as fh:
        fh.write(json.dumps(snap, sort_keys=True, default=str) + "\n")
    return snap


#: minimal exposition-format sample line (used by the test-suite parser too)
SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\d*\.\d+(?:[eE][-+]?\d+)?|Inf|NaN))$"
)
