"""Engine counters (counterpart of ``torchmetrics_tpu/engine/stats.py``).

Every ``CompiledUpdate`` / ``FusedUpdate`` (update engine) and every ``EpochEngine`` /
``CollectionEpoch`` (packed sync) owns one ``EngineStats``. All live instances
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
    # --- packed sync (engine/epoch.py) ---
    "packed_syncs",  # packed syncs completed
    "sync_collectives",  # collectives issued by packed syncs (metadata gather + one per buffer)
)


class EngineStats:
    """Mutable counter block for one engine instance (see ``_COUNTER_FIELDS``)."""

    __slots__ = ("owner", "fallback_reasons", "bucket_sizes", "__weakref__", *_COUNTER_FIELDS)

    def __init__(self, owner: str = "") -> None:
        self.owner = owner
        self.fallback_reasons: Counter = Counter()
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
        self.bucket_sizes.clear()

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {f: getattr(self, f) for f in _COUNTER_FIELDS}
        out["owner"] = self.owner
        out["bucket_count"] = len(self.bucket_sizes)
        if self.fallback_reasons:
            out["fallback_reasons"] = {k: self.fallback_reasons[k] for k in sorted(self.fallback_reasons)}
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
