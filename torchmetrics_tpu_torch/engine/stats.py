"""Counters of the sync path (counterpart of the packed-sync part of ``torchmetrics_tpu/engine/stats.py``).

Every ``EpochEngine`` / ``CollectionEpoch`` owns one ``EngineStats``. They are the
evidence that a sync took the packed route and how many collectives it issued.
"""

from __future__ import annotations

from collections import Counter


class EngineStats:
    """Mutable counter block for one engine instance.

    Attributes:
        packed_syncs: packed syncs completed.
        sync_collectives: collectives issued by packed syncs: the metadata gather, when
            a plan needs one, and one ``all_gather`` per buffer.
        eager_fallbacks: syncs that took the eager per-tensor path instead, with their
            reasons counted in ``fallback_reasons``.
    """

    __slots__ = ("owner", "packed_syncs", "sync_collectives", "eager_fallbacks", "fallback_reasons")

    def __init__(self, owner: str = "") -> None:
        self.owner = owner
        self.packed_syncs = 0
        self.sync_collectives = 0
        self.eager_fallbacks = 0
        self.fallback_reasons: Counter = Counter()

    def fallback(self, reason: str) -> None:
        """Count one sync that took the eager path, by reason."""
        self.eager_fallbacks += 1
        self.fallback_reasons[reason] += 1

    def __repr__(self) -> str:
        return (
            f"EngineStats({self.owner!r}, packed_syncs={self.packed_syncs},"
            f" sync_collectives={self.sync_collectives}, eager_fallbacks={self.eager_fallbacks})"
        )
