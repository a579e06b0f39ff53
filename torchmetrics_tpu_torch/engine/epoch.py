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

- **Cached compute** (``EpochEngine.cached_compute``, routed from ``Metric.compute``
  with the engine on): ``compute`` runs once per state signature as ``state -> value``
  (``traced_compute``) under the update engine's ``_Guard`` on the engine's own static
  copies of the states, and on the card is then captured into a CUDA graph; later
  computes copy the states in and replay. A host read, a nested metric,
  ``compute_on_cpu``, a list state or a compute with side effects falls back, counted
  under a ``compute:`` reason. The returned value never shares a static buffer's
  storage.
- **Fused sync-and-compute** (``EpochEngine.sync_and_compute``): the packed exchange
  (not captured: a gloo collective cannot be), then one graph for the fold and the
  compute over static copies of the gathered buffers.

Counters: ``compute_traces``, ``compute_dispatches``, ``compute_cache_hits``. The riders
ride the packed plan (``parallel/packing.py``): a compensated state's residual folds by
two-sum, the quarantine counter sums.

Left out against the JAX engine: the resilience layer (bounded collectives, degraded
re-plans), the in-graph mesh exchange, the sentinel's value checks and the sampled
drift audit, ``persist``, and the diagnostics (events, histograms, lineage).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.engine.compiled import (
    _FALLBACK,
    _Guard,
    _Ineligible,
    _container_changed,
    capture,
    holds_nested_metrics,
    state_signature,
)
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.utilities.data import apply_to_collection
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


#: the packed sync ran but the compute must run outside the fused graph: the caller
#: computes on the synced states
NO_VALUE = object()


def _write_synced(metric: Any, states: Dict[str, Any], plan: PackedSyncPlan, owner: str) -> None:
    from torchmetrics_tpu_torch.engine import numerics, txn

    for attr, val in states.items():
        if attr.startswith(numerics.SYNC_RES_PREFIX):
            # the two-sum fold's residual of a compensated state
            numerics.set_residual(metric, attr[len(numerics.SYNC_RES_PREFIX) :], val)
        elif attr == txn.ATTR:
            metric.__dict__[attr] = val
        else:
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


def traced_compute(metric: Any, state: Dict[str, Any], check: bool = True) -> Any:
    """Run ``metric``'s original compute as ``state -> value``.

    The metric's ``__dict__`` is snapshotted and restored wholesale. With ``check``, a
    compute with side effects a graph would lose (rebinding a state or another
    attribute, changing a container in place) raises ``_Ineligible``.
    """
    names = tuple(metric._defaults)
    snapshot = dict(metric.__dict__)
    containers = (
        {
            k: (list(v) if isinstance(v, list) else dict(v) if isinstance(v, dict) else set(v))
            for k, v in snapshot.items()
            if k not in names and isinstance(v, (list, dict, set))
        }
        if check
        else {}
    )
    try:
        for k in names:
            object.__setattr__(metric, k, state[k])
        value = metric._raw_compute()
        for k, v in metric.__dict__.items() if check else ():
            if k in names:
                if v is not state[k]:
                    raise _Ineligible(f"compute rebinds state {k!r}")
                continue
            if snapshot.get(k, _FALLBACK) is not v:
                raise _Ineligible(f"compute writes non-state attribute {k!r}")
            if k in containers and _container_changed(v, containers[k]):
                raise _Ineligible(f"compute mutates non-state container {k!r} in place")
        return value
    finally:
        metric.__dict__.clear()
        metric.__dict__.update(snapshot)
        for k, saved in containers.items():
            live = snapshot[k]
            if _container_changed(live, saved):
                if isinstance(live, list):
                    live[:] = saved
                else:
                    live.clear()
                    live.update(saved)


def _owned(value: Any) -> Any:
    """Every tensor of ``value`` as a copy: nothing handed out shares a static buffer."""
    return apply_to_collection(value, torch.Tensor, lambda t: t.clone())


class _GraphCall:
    """A built compute: its static inputs (a dict of tensors), on the card its graph
    and the outputs the graph writes; ``fn(inputs)`` is the body."""

    __slots__ = ("inputs", "fn", "graph", "outputs", "launches")

    def __init__(self, inputs: Dict[str, torch.Tensor], fn: Callable[[Dict[str, torch.Tensor]], Any]) -> None:
        self.inputs = inputs
        self.fn = fn
        self.graph: Any = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}

    def build(self, pool: Any, device: torch.device) -> Any:
        """The guarded first call (its result is this call's result), then the capture
        on a CUDA device."""
        with torch.no_grad(), _Guard():
            result = self.fn(self.inputs, True)
        if device.type == "cuda":

            def body() -> None:
                self.outputs = self.fn(self.inputs, False)

            self.graph, self.launches = capture(body, pool, device)
        return result

    def call(self, values: Dict[str, torch.Tensor]) -> Any:
        from torchmetrics_tpu_torch import ops

        with torch.no_grad():
            for k, buf in self.inputs.items():
                buf.copy_(values[k])
            if self.graph is None:
                return self.fn(self.inputs, False)
            self.graph.replay()
            ops.add_launches(self.launches)
            return self.outputs


class EpochEngine:
    """Packed sync, cached compute and the fused sync-and-compute for one metric; made
    at first use and left out of pickles."""

    def __init__(self, metric: Any) -> None:
        self._metric = metric
        self.stats = EngineStats("epoch:" + type(metric).__name__)
        self._fold_cache: Dict[Tuple, Callable] = {}
        self._compute_cache: Dict[Tuple, Any] = {}
        self._fused_cache: Dict[Tuple, Any] = {}
        self._transient_fails: Dict[Tuple, int] = {}
        self._pool: Any = None
        self._compute_ok = not holds_nested_metrics(metric) and "_raw_compute" in metric.__dict__

    def packed_sync(self) -> bool:
        """Write the synced states onto the metric; False requests the eager path."""
        return _packed_sync([("", self._metric)], self.stats, self._fold_cache)

    def _graph_pool(self, device: torch.device) -> Any:
        if device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _build(self, cache: Dict[Tuple, Any], key: Tuple, call: _GraphCall, device: torch.device, prefix: str) -> Tuple[bool, Any]:
        """Build ``call`` for ``key``: ``(True, first result)``, or ``(False, None)`` with
        the key demoted (counted) when the guard refuses it or it fails to build."""
        from torchmetrics_tpu_torch.engine import txn

        try:
            result = call.build(self._graph_pool(device), device)
        except Exception as exc:  # noqa: BLE001 -- an ineligible compute runs eagerly
            if call.graph is None:
                self._pool = None  # a failed capture may leave its pool recording
            classified = txn.classify_and_demote(cache, _FALLBACK, self._transient_fails, key, exc)
            if isinstance(exc, _Ineligible):
                reason = str(exc)
            elif classified is not None:
                reason = f"dispatch-{classified}"
            else:
                reason = f"trace-failed:{type(exc).__name__}"
            self.stats.fallback(f"{prefix}:{reason}")
            return False, None
        cache[key] = call
        self.stats.compute_traces += 1
        return True, result

    def cached_compute(self) -> Tuple[bool, Any]:
        """``compute`` through its built graph: ``(True, value)``, or ``(False, None)``
        (counted) to run it eagerly."""
        m = self._metric
        st = self.stats
        if not self._compute_ok:
            st.fallback("compute:nested-metric")
            return False, None
        if m.compute_on_cpu:
            st.fallback("compute:compute-on-cpu")
            return False, None
        state = {k: getattr(m, k) for k in m._defaults}
        if any(isinstance(v, list) for v in state.values()):
            st.fallback("compute:list-state")
            return False, None
        if not all(isinstance(v, torch.Tensor) for v in state.values()):
            st.fallback("compute:non-array-state")
            return False, None
        key = state_signature(state)
        call = self._compute_cache.get(key)
        if call is _FALLBACK:
            st.fallback("compute:uncompilable-signature")
            return False, None
        if call is None:

            def fn(inputs: Dict[str, torch.Tensor], check: bool) -> Any:
                return traced_compute(m, inputs, check)

            call = _GraphCall({k: v.clone(memory_format=torch.contiguous_format) for k, v in state.items()}, fn)
            built, value = self._build(self._compute_cache, key, call, m.device, "compute")
            if not built:
                return False, None
        else:
            value = call.call(state)
            st.compute_cache_hits += 1
        st.compute_dispatches += 1
        return True, _owned(value)

    def sync_and_compute(self) -> Optional[tuple]:
        """The fused route: the packed exchange, then one graph doing the fold and the
        compute. None when the states cannot be packed (the caller goes eager); else a
        1-tuple of the value (``NO_VALUE`` when the compute half falls back and runs on
        the synced states), the synced states written onto the metric."""
        m = self._metric
        st = self.stats
        try:
            plan = PackedSyncPlan([("", m)], _world_size())
        except PackingError as exc:
            st.fallback(f"sync:{exc}")
            return None
        gathered = _exchange(plan, st)
        key = ("fused", plan.signature())
        call = self._fused_cache.get(key)
        if call is _FALLBACK or not self._compute_ok:
            return self._fold_then_no_value(plan, gathered)
        if call is None:
            fold = plan.make_fold()

            def fn(inputs: Dict[str, torch.Tensor], check: bool) -> Any:
                states = fold(inputs).get("", {})
                return states, traced_compute(m, states, check)

            call = _GraphCall({k: v.clone() for k, v in gathered.items()}, fn)
            built, result = self._build(self._fused_cache, key, call, m.device, "compute")
            if not built:
                return self._fold_then_no_value(plan, gathered)
        else:
            result = call.call(gathered)
            st.compute_cache_hits += 1
        states, value = _owned(result)
        st.compute_dispatches += 1
        st.packed_syncs += 1
        _write_synced(m, states, plan, "")
        return (value,)

    def _fold_then_no_value(self, plan: PackedSyncPlan, gathered: Dict[str, torch.Tensor]) -> tuple:
        """The fold alone, for an exchange whose compute cannot fuse."""
        folded = _run_fold(plan, gathered, self._fold_cache)
        _write_synced(self._metric, folded.get("", {}), plan, "")
        self.stats.packed_syncs += 1
        return (NO_VALUE,)


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

