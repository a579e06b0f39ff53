"""Engine counters (counterpart of ``torchmetrics_tpu/engine/stats.py``).

Every ``CompiledUpdate`` / ``FusedUpdate`` (update engine, with its scan queue and
async drains) and every ``EpochEngine`` / ``CollectionEpoch`` (packed sync, cached
compute) owns one ``EngineStats``; a metric that quarantines or compensates with no
engine gets one too (``engine/txn.py``). All live instances
register in a module-level weak set, so ``engine_report`` can aggregate a
process-wide view without keeping dead metrics alive. The counters are the evidence
that an update took a captured graph ("0 captures after warm-up", "one replay per
fused step") or that a sync took the packed route. Every fallback is also a ``fallback``
event of the flight recorder (``diag/trace.py``), and a build past a signature's first is
counted by its attributed cause in ``retrace_causes``.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict

from torchmetrics_tpu_torch.diag import trace as _diag

_REGISTRY: "weakref.WeakSet[EngineStats]" = weakref.WeakSet()

_COUNTER_FIELDS = (
    # --- update engine (engine/compiled.py, engine/fusion.py) ---
    "traces",  # signatures built (each: one guarded warm-up step, plus one capture on the card)
    "captures",  # CUDA graphs captured (0 on the CPU, where a signature runs its plain step)
    "cache_hits",  # steps served by an already-built signature
    "dispatches",  # engine-handled steps (fused: 1 per N-metric step)
    "replays",  # CUDA graph replays (dispatches minus captures on the card; 0 on the CPU)
    "metrics_updated",  # metric updates performed through engine steps (fused: N per step)
    "eager_fallbacks",  # steps that fell back to the eager path, by reason in fallback_reasons
    "donation_copies",  # live states copied into the static buffers before a step (every step donates)
    "bucketed_steps",  # steps that rode a shape bucket
    "bucket_pad_rows",  # pad rows added across bucketed steps
    "input_copy_bytes",  # bytes copied into static input buffers (the batch, once per step)
    # --- multi-step scan dispatch (engine/scan.py): queued K-step drains ---
    "scan_dispatches",  # scan drains executed (each = one replay of a kb-step graph)
    "scan_steps_folded",  # real update steps folded across all scan drains
    "scan_pad_steps",  # masked no-op steps added to fill a power-of-two kb graph
    "scan_flushes",  # queue flushes (drains + discards), by reason in scan_flush_reasons
    # --- async background drains (engine/async_dispatch.py) ---
    "async_submits",  # buffers swapped out and handed to the background worker
    "async_dispatches",  # background drains the worker replayed
    "async_joins",  # observation joins that actually waited on in-flight work
    "async_join_wait_us",  # host µs observers spent waiting at joins
    "async_overlap_us",  # worker drain µs during which no caller waited on it
    "async_backpressure_waits",  # submits that blocked on the bounded in-flight window
    "async_replayed_steps",  # steps replayed on the caller after a worker drain failed
    # --- transactional layer (engine/txn.py): quarantine + fallback ladder ---
    "quarantined_batches",  # poisoned batches skipped in-graph (filled at the sanctioned read)
    "ladder_retries",  # build failures that stepped down to a smaller bucket
    # --- numerics layer (engine/numerics.py): compensated accumulation ---
    "compensated_steps",  # updates whose accumulate rode the two-sum
    "reanchors",  # epoch-boundary (value, residual) folds into a clean anchor
    "drift_probes",  # sampled drift-audit reads at the sanctioned boundary
    "drift_flags",  # probes whose relative drift exceeded TORCHMETRICS_TPU_DRIFT_RTOL
    # --- packed sync (engine/epoch.py) ---
    "packed_syncs",  # packed syncs completed
    "sync_collectives",  # collectives issued by packed syncs (metadata gather + one per buffer)
    "sync_metadata_gathers",  # metadata exchanges issued (0 for a rank-invariant plan without the timeline)
    "sync_bytes_moved",  # bytes through packed-sync buffer collectives (gathered view)
    "sync_divergence_flags",  # rank-divergent rank-invariant states flagged by the audit
    "sync_straggler_flags",  # packed syncs whose arrival skew exceeded the straggler threshold
    "sync_retries",  # bounded-collective retries spent inside packed exchanges
    "sync_degraded_folds",  # packed syncs folded over a degraded (survivor) membership
    "compute_traces",  # compute graphs built (each: one guarded run, plus one capture on the card)
    "compute_dispatches",  # computes served by a built graph (fused sync-and-compute included)
    "compute_cache_hits",  # compute dispatches served without a new build
    # --- profiling layer (diag/profile.py): sampled completion probes ---
    "profile_probes",  # warm dispatches followed by a sanctioned wait on their end event
    # --- state-spec registry (engine/statespec.py) ---
    "spec_fallbacks",  # specs derived for states registered without add_state
    # --- sharded state (parallel/sharding.py) ---
    "shard_states",  # states placed distributed by a resolved shard rule (born or re-placed)
    "psum_syncs",  # additive sharded states whose sync needs no gather (1-D) or one all-reduce over data (2-D)
    "gather_skipped",  # sharded states the packed gather skipped
    "shard_degrades",  # shard-rule resolutions degraded to replication (scalar, no state axis, indivisible)
    "ingraph_syncs",  # packed exchanges that rode the mesh's data sub-group
    "sync_noop_plans",  # packed syncs skipped wholesale: nothing to pack (every state sharded)
    # --- the signature manifest (engine/persist.py): zero-cold-start serving ---
    "persist_hits",  # builds served by a persisted graph (0: a CUDA graph does not load)
    "persist_misses",  # builds that looked for a persisted graph with persistence on (every one)
    "prewarm_replays",  # manifest rows replayed by prewarm() before traffic landed
    # --- heavy-workload host paths (detection/mean_ap.py) ---
    "map_host_evals",  # mAP computes evaluated by the host matcher (list, RLE and packed-dict routes)
    # --- value provenance & freshness plane (diag/lineage.py) ---
    "lineage_records",  # ValueProvenance records built at observation sites
    "lineage_spans",  # causal spans opened at enqueue (one per drain generation)
    "lineage_coverage_folds",  # coverage attestations stamped at fold sites
    # --- federated aggregation plane (serve/federation.py): cross-pod folds ---
    "federation_ingests",  # pod snapshots accepted (version+CRC verified, watermark advanced)
    "federation_folds",  # global folds executed over the verified pod membership
    "federation_degraded_folds",  # global folds over a degraded (pod-excluding) membership
    "federation_stale_skips",  # snapshots rejected by the watermark/staleness dedupe
    # --- fleet observability plane (serve/fleet.py): cross-pod telemetry federation ---
    "fleet_pulls",  # pod telemetry envelopes accepted (version+CRC verified, watermark advanced)
    "fleet_merges",  # fleet-wide telemetry merges over the fresh pod membership
    "fleet_degraded_pulls",  # pods excluded from a pull/merge round (fault, stale, never pulled)
    # --- declarative SLO engine (diag/slo.py): rolling-window objective evaluation ---
    "slo_evaluations",  # SLO evaluation passes (every spec, fast+slow burn windows)
    "slo_breaches",  # SLO compliance transitions into breach (slo.breach events)
    "slo_recoveries",  # SLO compliance transitions back to healthy (slo.recover events)
)


class EngineStats:
    """Mutable counter block for one engine instance (see ``_COUNTER_FIELDS``)."""

    __slots__ = (
        "owner", "fallback_reasons", "last_fallback", "scan_flush_reasons", "retrace_causes", "bucket_sizes",
        "__weakref__",
        *_COUNTER_FIELDS,
    )

    def __init__(self, owner: str = "") -> None:
        self.owner = owner
        self.fallback_reasons: Counter = Counter()
        self.last_fallback = ""  # the reason of the newest fallback (an ``eager.update`` span's)
        self.scan_flush_reasons: Counter = Counter()
        self.retrace_causes: Counter = Counter()  # attributed causes of builds past a signature's first
        self.bucket_sizes: set = set()
        for f in _COUNTER_FIELDS:
            setattr(self, f, 0)
        _REGISTRY.add(self)

    def fallback(self, reason: str) -> None:
        """Count one step or sync that took the eager path, by reason."""
        self.eager_fallbacks += 1
        self.fallback_reasons[reason] += 1
        self.last_fallback = reason
        _diag.record("fallback", self.owner, reason=reason)

    def reset(self) -> None:
        for f in _COUNTER_FIELDS:
            setattr(self, f, 0)
        self.fallback_reasons.clear()
        self.scan_flush_reasons.clear()
        self.retrace_causes.clear()
        self.bucket_sizes.clear()

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {f: getattr(self, f) for f in _COUNTER_FIELDS}
        out["owner"] = self.owner
        out["bucket_count"] = len(self.bucket_sizes)
        if self.fallback_reasons:
            out["fallback_reasons"] = {k: self.fallback_reasons[k] for k in sorted(self.fallback_reasons)}
        if self.scan_flush_reasons:
            out["scan_flush_reasons"] = {k: self.scan_flush_reasons[k] for k in sorted(self.scan_flush_reasons)}
        if self.retrace_causes:
            out["retrace_causes"] = {k: self.retrace_causes[k] for k in sorted(self.retrace_causes)}
        return out

    def __repr__(self) -> str:
        body = ", ".join(f"{f}={getattr(self, f)}" for f in _COUNTER_FIELDS if getattr(self, f))
        return f"EngineStats({self.owner!r}, {body})"


def engine_report(reset: bool = False) -> Dict[str, Any]:
    """Counters summed over every live engine in the process, with ``engines`` (how
    many), ``bucket_count`` and the merged ``fallback_reasons``; ``reset`` zeroes
    every engine's counters after reading."""
    total: Dict[str, Any] = {f: 0 for f in _COUNTER_FIELDS}
    reasons: Counter = Counter()
    causes: Counter = Counter()
    buckets: set = set()
    engines = 0
    for st in list(_REGISTRY):
        engines += 1
        for f in _COUNTER_FIELDS:
            total[f] += getattr(st, f)
        reasons.update(st.fallback_reasons)
        causes.update(st.retrace_causes)
        buckets |= st.bucket_sizes
    total["engines"] = engines
    total["bucket_count"] = len(buckets)
    if reasons:
        total["fallback_reasons"] = {k: reasons[k] for k in sorted(reasons)}
    if causes:
        total["retrace_causes"] = {k: causes[k] for k in sorted(causes)}
    if reset:
        reset_engine_stats()
    return total


def reset_engine_counters() -> None:
    """Zero every live engine's counters, leaving any recorder untouched (for a caller
    that manages its own ``FlightRecorder``, as ``diag_report(rec, reset=True)`` does)."""
    for st in list(_REGISTRY):
        st.reset()


def reset_engine_stats() -> None:
    """Zero every live engine's counters, the fault-tolerance counters
    (``parallel/resilience.py``), the active flight recorder, the cost ledger, the
    sentinels, the quarantine counters, the histograms, the probe accounting, the
    lineage watermarks, the SLO windows and the persistence counters (``engine/persist.py``),
    in lockstep: a surface reset alone would attribute the previous run's events, costs,
    flags or tails to the next."""
    from torchmetrics_tpu_torch.diag.costs import reset_ledger
    from torchmetrics_tpu_torch.diag.hist import reset_histograms
    from torchmetrics_tpu_torch.diag.lineage import reset_lineage
    from torchmetrics_tpu_torch.diag.profile import reset_profile
    from torchmetrics_tpu_torch.diag.sentinel import reset_sentinels
    from torchmetrics_tpu_torch.diag.slo import reset_slo
    from torchmetrics_tpu_torch.engine.persist import reset_persist_stats
    from torchmetrics_tpu_torch.engine.txn import reset_quarantine
    from torchmetrics_tpu_torch.parallel.resilience import reset_resilience

    reset_engine_counters()
    _diag.clear_recorder()
    reset_ledger()
    reset_sentinels()
    reset_quarantine()
    reset_histograms()
    reset_profile()
    reset_resilience()
    reset_lineage()
    reset_slo()
    reset_persist_stats()
