"""Engine counters (counterpart of ``torchmetrics_tpu/engine/stats.py``).

Every ``CompiledUpdate`` / ``FusedUpdate`` (update engine, with its scan queue and
async drains) and every ``EpochEngine`` / ``CollectionEpoch`` (packed sync, cached
compute) owns one ``EngineStats``; a metric that quarantines or compensates with no
engine gets one too (``engine/txn.py``). All live instances
register in a module-level weak set, so ``engine_report`` can aggregate a
process-wide view without keeping dead metrics alive. The counters are the evidence
that an update took a captured graph ("0 captures after warm-up", "one replay per
fused step") or that a sync took the packed route.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Dict

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
    # --- packed sync (engine/epoch.py) ---
    "packed_syncs",  # packed syncs completed
    "sync_collectives",  # collectives issued by packed syncs (metadata gather + one per buffer)
    "compute_traces",  # compute graphs built (each: one guarded run, plus one capture on the card)
    "compute_dispatches",  # computes served by a built graph (fused sync-and-compute included)
    "compute_cache_hits",  # compute dispatches served without a new build
    # --- heavy-workload host paths (detection/mean_ap.py) ---
    "map_host_evals",  # mAP computes evaluated by the host matcher (list, RLE and packed-dict routes)
)


class EngineStats:
    """Mutable counter block for one engine instance (see ``_COUNTER_FIELDS``)."""

    __slots__ = ("owner", "fallback_reasons", "scan_flush_reasons", "bucket_sizes", "__weakref__", *_COUNTER_FIELDS)

    def __init__(self, owner: str = "") -> None:
        self.owner = owner
        self.fallback_reasons: Counter = Counter()
        self.scan_flush_reasons: Counter = Counter()
        self.bucket_sizes: set = set()
        for f in _COUNTER_FIELDS:
            setattr(self, f, 0)
        _REGISTRY.add(self)

    def fallback(self, reason: str) -> None:
        """Count one step or sync that took the eager path, by reason."""
        self.eager_fallbacks += 1
        self.fallback_reasons[reason] += 1

    def reset(self) -> None:
        for f in _COUNTER_FIELDS:
            setattr(self, f, 0)
        self.fallback_reasons.clear()
        self.scan_flush_reasons.clear()
        self.bucket_sizes.clear()

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {f: getattr(self, f) for f in _COUNTER_FIELDS}
        out["owner"] = self.owner
        out["bucket_count"] = len(self.bucket_sizes)
        if self.fallback_reasons:
            out["fallback_reasons"] = {k: self.fallback_reasons[k] for k in sorted(self.fallback_reasons)}
        if self.scan_flush_reasons:
            out["scan_flush_reasons"] = {k: self.scan_flush_reasons[k] for k in sorted(self.scan_flush_reasons)}
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
    buckets: set = set()
    engines = 0
    for st in list(_REGISTRY):
        engines += 1
        for f in _COUNTER_FIELDS:
            total[f] += getattr(st, f)
        reasons.update(st.fallback_reasons)
        buckets |= st.bucket_sizes
    total["engines"] = engines
    total["bucket_count"] = len(buckets)
    if reasons:
        total["fallback_reasons"] = {k: reasons[k] for k in sorted(reasons)}
    if reset:
        reset_engine_stats()
    return total


def reset_engine_stats() -> None:
    """Zero every live engine's counters."""
    for st in list(_REGISTRY):
        st.reset()
