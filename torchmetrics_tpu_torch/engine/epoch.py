"""Packed epoch sync (counterpart of the sync part of ``torchmetrics_tpu/engine/epoch.py``).

- ``EpochEngine`` (one per ``Metric``, made at its first sync): all of a metric's
  states ride one ``PackedSyncPlan``, so a sync is at most one metadata gather plus
  one ``all_gather`` per (role, dtype) buffer, then one fold.
- ``CollectionEpoch`` (one per ``MetricCollection``): one plan spans every
  compute-group owner, so a whole collection syncs in O(dtypes) collectives.

Collectives run over ``torch.distributed``'s default group, which the caller set up
(any backend; the port picks none). A world of one process issues no collective: the
gathered view is the local buffer with a leading axis of 1. The fold is a plain
function of torch ops, cached per plan signature. What cannot ride the plan raises
``PackingError`` and is counted as a fallback in ``EngineStats`` before the caller
takes the eager path.

Left out against the JAX engine: the fused sync-and-compute executable and the cached
compute, the resilience layer (bounded collectives, degraded re-plans), the in-graph
mesh exchange, and the diagnostics (events, histograms, lineage).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan, PackingError, all_gather_backbone
from torchmetrics_tpu_torch.parallel.sync import distributed_available


def _world_size() -> int:
    return dist.get_world_size() if distributed_available() else 1


def _exchange(plan: PackedSyncPlan, stats: EngineStats) -> Dict[str, torch.Tensor]:
    """Run the metadata exchange (when the plan needs one) and one ``all_gather`` per
    buffer; returns ``{buffer_key: (world, n) tensor}``.

    Every collective issued is counted in ``stats.sync_collectives``. Metadata
    validation errors propagate: they fail loud on every rank.
    """
    meta = plan.metadata_local()
    if meta is None:
        plan.finalize(None)
    elif plan.world_size == 1:
        plan.finalize(meta[None, :])
    else:
        local = torch.as_tensor(meta, device=plan.device)
        plan.finalize(all_gather_backbone(local).cpu().numpy())
        stats.sync_collectives += 1
    gathered: Dict[str, torch.Tensor] = {}
    for key, buf in sorted(plan.pack().items()):  # the same collective order on every rank
        if plan.world_size == 1:
            gathered[key] = buf[None]
            continue
        gathered[key] = all_gather_backbone(buf)
        stats.sync_collectives += 1
    return gathered


def _write_synced(metric: Any, states: Dict[str, Any], plan: PackedSyncPlan, owner: str) -> None:
    for attr, val in states.items():
        setattr(metric, attr, val)
    for attr in plan.none_folded_attrs(owner):
        metric._none_folded.add(attr)


def _run_fold(
    plan: PackedSyncPlan, gathered: Dict[str, torch.Tensor], cache: Dict[Tuple, Callable]
) -> Dict[str, Dict[str, Any]]:
    """Apply the plan's fold, made once per ``plan.signature()``."""
    sig = plan.signature()
    fold = cache.get(sig)
    if fold is None:
        fold = cache[sig] = plan.make_fold()
    return fold(gathered)


def _packed_sync(
    owners: Sequence[Tuple[str, Any]], stats: EngineStats, cache: Dict[Tuple, Callable]
) -> bool:
    """Sync every owner's states in one exchange; False (counted) when the layout
    cannot be packed and the caller must sync eagerly."""
    try:
        plan = PackedSyncPlan(list(owners), _world_size())
    except PackingError as exc:
        stats.fallback(f"sync:{exc}")
        return False
    folded = _run_fold(plan, _exchange(plan, stats), cache)
    for name, metric in owners:
        _write_synced(metric, folded.get(name, {}), plan, name)
    stats.packed_syncs += 1
    return True


class EpochEngine:
    """Packed sync for one metric; made at its first sync and left out of pickles."""

    def __init__(self, metric: Any) -> None:
        self._metric = metric
        self.stats = EngineStats("epoch:" + type(metric).__name__)
        self._fold_cache: Dict[Tuple, Callable] = {}

    def packed_sync(self) -> bool:
        """Write the synced states onto the metric; False requests the eager path."""
        return _packed_sync([("", self._metric)], self.stats, self._fold_cache)


class CollectionEpoch:
    """One packed plan spanning every compute-group owner of a collection."""

    def __init__(self, names: Sequence[str]) -> None:
        self.names = list(names)
        self.stats = EngineStats("epoch:collection[" + ",".join(self.names) + "]")
        self._fold_cache: Dict[Tuple, Callable] = {}

    def packed_sync(self, owners: Sequence[Tuple[str, Any]]) -> bool:
        """Sync every owner in one exchange; True when handled. The caller keeps the
        pre-sync snapshots and the ``_is_synced`` bookkeeping."""
        return _packed_sync(owners, self.stats, self._fold_cache)

