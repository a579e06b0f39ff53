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

- **Fault tolerance**: every collective of the exchange is bounded
  (``parallel/resilience.py``). A classified fault re-plans the exchange over the
  surviving ranks (``_degraded_replan``), one culprit per pass, unless
  ``TORCHMETRICS_TPU_DEGRADED=0``. The culprit is the rank the fault names, else the
  last straggler the timeline named (``resilience.note_straggler``, consumed once). An
  in-flight deadline escape leaves the group out of step, so its re-plan issues no
  further collective: when this rank is the only survivor it folds its own rows
  (``local_only``); otherwise the typed error propagates. The fold of a degraded plan is
  cached under its own signature (``members`` is part of it), counted in
  ``sync_degraded_folds`` when it completes beside a ``sync.degraded`` event, and its
  membership is stamped as a lineage coverage record (``diag/lineage.note_coverage``).
  Retries spent inside the bounded collectives add to ``sync_retries``.
- **Diagnostics**: the metadata gather runs inside ``transfer_allowed("sync-metadata")``
  and every buffer collective inside its ``collective:<label>`` boundary. An exchange
  records ``sync.exchange`` (``sync.noop`` for an empty plan) and feeds the ``sync_us``
  / ``sync_bytes`` histograms; the divergence audit's findings become ``sync.audit``
  events (``sync_divergence_flags``), a timeline skew past the straggler threshold a
  ``sync.straggler`` event (``sync_straggler_flags``) and the straggler hint; with
  profiling on, the barrier exit is stamped for the next sync's clock offsets. A cached
  or fused compute records ``compute.trace`` / ``retrace`` / ``dispatch`` (and sampled
  ``compute.probe``s), feeds ``dispatch_us`` / ``compute_us``, folds the sentinel's value
  checks into its graph (``diag/sentinel.value_flags``) and observes the lineage
  watermark (``ValueProvenance`` on ``metric._provenance``). Each build lands in the
  cost ledger (kinds ``compute`` and ``sync-compute``).

Counters: ``compute_traces``, ``compute_dispatches``, ``compute_cache_hits``,
``sync_retries``, ``sync_degraded_folds``, ``sync_metadata_gathers``,
``sync_bytes_moved``, ``sync_divergence_flags``, ``sync_straggler_flags``. The riders
ride the packed plan (``parallel/packing.py``): a compensated state's residual folds by
two-sum, the quarantine counter sums, the sentinel ORs.

- **Sharded state** (``parallel/sharding.py``): the plan leaves live-sharded states
  out (``skipped_sharded``; counted in ``gather_skipped``, additive ones in
  ``psum_syncs``, a ``sync.shard_skip`` event). Under a state mesh the exchange runs
  over the rank's ``data`` sub-group (``sharding.sync_scope``; ``ingraph_syncs``, a
  ``sync.ingraph`` event), and on a ``(data, state)`` mesh each sharded state is then
  folded over that sub-group, one all-reduce each: the fold the JAX update executable
  makes in-graph at every step, deferred to the sync. A plan with nothing to pack
  issues no collective (``sync_noop_plans``). A metric holding a sharded state takes
  the packed sync and computes on the assembled states (``Metric.compute``), never the
  fused route.

Left out against the JAX engine: ``persist`` and the async epoch-sync overlap notes.
"""

from __future__ import annotations

from time import perf_counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.engine.compiled import (
    _FALLBACK,
    _Guard,
    _Ineligible,
    _container_changed,
    annotation_scope,
    completion_probe,
    holds_nested_metrics,
    measured_capture,
    note_build,
    probe_events,
    state_signature,
    timed_replay,
)
from torchmetrics_tpu_torch.diag import costs as _costs
from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import profile as _profile
from torchmetrics_tpu_torch.diag import sentinel as _sentinel
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.utilities.data import apply_to_collection
from torchmetrics_tpu_torch.parallel import packing as _packing
from torchmetrics_tpu_torch.parallel import resilience as _resilience
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan, PackingError, all_gather_backbone


def _degraded_replan(
    plan: PackedSyncPlan, stats: EngineStats, exc: _resilience.SyncFaultError
) -> PackedSyncPlan:
    """A plan over the surviving ranks after a classified fault, or ``exc`` re-raised.

    The culprit is the rank the fault names, else the straggler hint (consumed once).
    No culprit, degraded folds forbidden, a culprit outside the members or no survivor
    left: the typed error propagates. After an in-flight escape the group is out of
    step: the re-plan is ``local_only`` (no collective) when this rank is the only
    survivor, and the error propagates otherwise.
    """
    policy = _resilience.current_policy()
    culprit = exc.rank if exc.rank is not None else _resilience.consume_straggler_hint()
    if not policy.degraded or culprit is None or culprit not in plan.members or len(plan.members) < 2:
        raise exc
    survivors = tuple(m for m in plan.members if m != culprit)
    in_flight = bool(getattr(exc, "in_flight", False))
    if in_flight and survivors != (plan._local_rank(),):
        raise exc
    _diag.record(
        "sync.degraded", stats.owner,
        rank=int(culprit), error=type(exc).__name__, label=exc.label,
        survivors=survivors, attempts=exc.attempts,
    )
    replanned = PackedSyncPlan(plan._metrics, plan.world_size, survivors, group=plan.group)
    replanned.degraded = True
    replanned.excluded_ranks = plan.excluded_ranks + (int(culprit),)
    if in_flight:
        replanned.local_only = True
        replanned.audit = replanned.timeline = False  # nothing crosses ranks
    return replanned


def _note_plan_coverage(stats: EngineStats, plan: PackedSyncPlan) -> None:
    """Stamp a packed sync's membership when it did not cover the full world: later
    observations of the synced value carry who contributed and who was excluded."""
    if plan.degraded or len(plan.members) != plan.world_size:
        _lineage.note_coverage(
            stats.owner, [str(r) for r in plan.members], excluded=[(r, "sync-fault") for r in plan.excluded_ranks]
        )


def _exchange(plan: PackedSyncPlan, stats: EngineStats) -> Tuple[Dict[str, torch.Tensor], PackedSyncPlan]:
    """Run the bounded exchange; returns ``(gathered, live plan)``, the plan the caller
    folds and caches against (a degraded re-plan when a fault excluded a rank).

    Each pass excludes at most one culprit, so the loop ends within the world size. A
    degraded fold is counted when its exchange completes; retries spent inside the
    bounded collectives add to ``stats.sync_retries``.
    """
    retries_before = _resilience.total_retries()
    try:
        while True:
            try:
                gathered = _exchange_once(plan, stats)
                if plan.degraded:
                    stats.sync_degraded_folds += 1
                if plan.skipped_sharded:
                    # their sync is global by construction, or one all-reduce over data
                    stats.gather_skipped += len(plan.skipped_sharded)
                    stats.psum_syncs += sum(1 for _, _, fold, _ in plan.skipped_sharded if fold in ("sum", "mean"))
                    _diag.record(
                        "sync.shard_skip", stats.owner, states=len(plan.skipped_sharded),
                        attrs=tuple(f"{o}:{a}" if o else a for o, a, _, _ in plan.skipped_sharded),
                    )
                return gathered, plan
            except _resilience.SyncFaultError as exc:
                plan = _degraded_replan(plan, stats, exc)
    finally:
        stats.sync_retries += _resilience.total_retries() - retries_before


def _exchange_once(plan: PackedSyncPlan, stats: EngineStats) -> Dict[str, torch.Tensor]:
    """Run the metadata exchange (when the plan needs one) and one ``all_gather`` per
    buffer; returns ``{buffer_key: (world, n) tensor}``, then acts on what the metadata
    carried (the audit's findings, the timeline's straggler).

    Every collective issued is counted in ``stats.sync_collectives``. Metadata
    validation errors propagate: they fail loud on every rank.
    """
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed
    from torchmetrics_tpu_torch.parallel.packing import stamp_arrival_into

    rec = _diag.active_recorder()
    profiling = _profile.active_profile() is not None
    measuring = rec is not None or profiling
    t0 = perf_counter() if measuring else 0.0
    if not plan.specs and not plan.timeline:
        # every state is live-sharded (or the plan is empty): no buffer, no metadata
        plan.finalize(None)
        stats.sync_noop_plans += 1
        _diag.record("sync.noop", stats.owner, world=plan.world_size, sharded=len(plan.skipped_sharded))
        return {}
    from torchmetrics_tpu_torch.parallel import sharding as _sharding

    mode = "local" if plan.world_size == 1 or plan.local_only else (
        _packing.ingraph_sync_mode(plan, _sharding.metric_state_mesh(plan._metrics[0][1]), plan.world_size) or "host"
    )
    meta = plan.metadata_local()
    had_meta = False
    if meta is None:
        plan.finalize(None)
    elif plan.world_size == 1 or plan.local_only:
        plan.finalize(np.repeat(meta[None, :], plan.world_size, axis=0))
    else:
        had_meta = True
        with transfer_allowed("sync-metadata"):
            local = torch.as_tensor(meta, device=plan.device)
            stamp = stamp_arrival_into if plan.timeline else None
            world_meta = all_gather_backbone(
                local, label="meta", members=plan.members, on_enter=stamp, group=plan.group
            ).cpu().numpy()
        plan.finalize(world_meta)
        stats.sync_collectives += 1
        stats.sync_metadata_gathers += 1
    gathered: Dict[str, torch.Tensor] = {}
    bytes_moved = 0
    for key, buf in sorted(plan.pack().items()):  # the same collective order on every rank
        if plan.world_size == 1 or plan.local_only:
            # a local-only re-plan reads its own row alone: every row is this rank's
            gathered[key] = buf[None].expand((plan.world_size,) + tuple(buf.shape))
            continue
        if mode == "mesh":
            gathered[key] = _packing.mesh_world_view(buf, plan, label=key)
            stats.psum_syncs += key.startswith("reduce:")
        else:
            gathered[key] = all_gather_backbone(buf, label=key, members=plan.members, group=plan.group)
        stats.sync_collectives += 1
        bytes_moved += int(buf.nbytes) * plan.world_size
    stats.sync_bytes_moved += bytes_moved
    if mode == "mesh":
        stats.ingraph_syncs += 1
        _diag.record("sync.ingraph", stats.owner, world=plan.world_size, buffers=len(gathered), mode=mode)
    for finding in plan.audit_results:
        if finding["flag"]:
            if finding["flag"] == "rank-invariant-divergence":
                stats.sync_divergence_flags += 1
            _diag.record(
                "sync.audit", finding["owner"] or stats.owner,
                attr=finding["attr"], flag=finding["flag"], divergent=finding["divergent"],
            )
    timeline = plan.timeline_result
    if timeline is not None and timeline["calibrated"] and timeline["skew_us"] > _profile.straggler_threshold_us():
        stats.sync_straggler_flags += 1
        # a later timeout with no culprit of its own degrades onto this rank
        _resilience.note_straggler(timeline["last_rank"])
        _diag.record(
            "sync.straggler", stats.owner,
            rank=timeline["last_rank"], skew_us=timeline["skew_us"],
            corrected_us=tuple(timeline["corrected_us"]), offsets_us=tuple(timeline["offsets_us"]),
        )
    if profiling:
        # the barrier-exit anchor of the next sync's clock-offset estimate
        _profile.note_sync_exit()
    if measuring:
        sync_us = round((perf_counter() - t0) * 1e6, 3)
        _hist.observe(stats.owner, "sync", "sync_us", sync_us)
        _hist.observe(stats.owner, "sync", "sync_bytes", bytes_moved)
        if rec is not None:
            rec.record(
                "sync.exchange", stats.owner, dispatch_us=sync_us, world=plan.world_size,
                buffers=len(gathered), metadata=had_meta, bytes=bytes_moved, mode=mode,
            )
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
        elif attr in (txn.ATTR, _sentinel.ATTR):
            # the sentinel stays ORed after unsync (sticky across syncs, as in JAX)
            metric.__dict__[attr] = val
        else:
            setattr(metric, attr, val)
    for attr in plan.none_folded_attrs(owner):
        metric._none_folded.add(attr)


def _fold_sharded(plan: PackedSyncPlan, stats: EngineStats) -> None:
    """Fold each skipped sharded state over the data sub-group (a ``(data, state)``
    mesh): one all-reduce per state, written onto its metric. On a 1-D mesh (world 1)
    a sharded state is global already."""
    if not plan.skipped_sharded or plan.world_size < 2 or plan.group is None:
        return
    from torchmetrics_tpu_torch.parallel import sharding as _sharding

    for _, attr, fold, metric in plan.skipped_sharded:
        if fold not in ("sum", "mean", "max", "min"):
            raise PackingError(f"sharded state {attr!r} with fold {fold!r} cannot fold over the data axis")
        setattr(metric, attr, _sharding.fold_over_data(getattr(metric, attr), fold, plan.group, plan.world_size))
        stats.sync_collectives += 1


def _run_fold(
    plan: PackedSyncPlan, gathered: Dict[str, torch.Tensor], cache: Dict[Tuple, Callable]
) -> Dict[str, Dict[str, Any]]:
    """Apply the plan's fold, made once per ``plan.signature()``."""
    sig = plan.signature()
    fold = cache.get(sig)
    if fold is None:
        fold = cache[sig] = plan.make_fold()
    return fold(gathered)


def _sync_scope(owners: Sequence[Tuple[str, Any]]) -> Tuple[int, None, Any]:
    """``(world size, members, group)`` of an exchange over ``owners``: the default
    group, or the data sub-group of a state mesh (``sharding.sync_scope``)."""
    from torchmetrics_tpu_torch.parallel import sharding as _sharding

    world, group = _sharding.sync_scope([m for _, m in owners])
    return world, None, group


def _packed_sync(
    owners: Sequence[Tuple[str, Any]], stats: EngineStats, cache: Dict[Tuple, Callable]
) -> bool:
    """Sync every owner's states in one exchange; False (counted) when the layout
    cannot be packed and the caller must sync eagerly."""
    try:
        plan = PackedSyncPlan(list(owners), *_sync_scope(owners))
    except PackingError as exc:
        stats.fallback(f"sync:{exc}")
        return False
    gathered, plan = _exchange(plan, stats)
    folded = _run_fold(plan, gathered, cache)
    for name, metric in owners:
        _write_synced(metric, folded.get(name, {}), plan, name)
    _fold_sharded(plan, stats)
    stats.packed_syncs += 1
    _note_plan_coverage(stats, plan)
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
    and the outputs the graph writes; ``fn(inputs)`` is the body. ``scope`` is its
    attribution scope."""

    __slots__ = ("inputs", "fn", "graph", "outputs", "launches", "scope")

    def __init__(self, inputs: Dict[str, torch.Tensor], fn: Callable[[Dict[str, torch.Tensor]], Any]) -> None:
        self.inputs = inputs
        self.fn = fn
        self.graph: Any = None
        self.outputs: Any = None
        self.launches: Dict[str, int] = {}
        self.scope = ""

    def build(self, pool: Any, device: torch.device, owner: str, kind: str, key: Tuple) -> Any:
        """The guarded first call (its result is this call's result), then the capture
        on a CUDA device; the build lands in the cost ledger."""
        t_build = perf_counter()
        self.scope = annotation_scope(owner, kind, key)
        with torch.no_grad(), _Guard():
            result = self.fn(self.inputs, True)
        capture_ms = pool_bytes = None
        if device.type == "cuda":

            def body() -> None:
                self.outputs = self.fn(self.inputs, False)

            (self.graph, self.launches), capture_ms, pool_bytes = measured_capture(body, pool, device)
        _costs.record_build(
            owner, kind, _costs.key_digest(key), (perf_counter() - t_build) * 1e3,
            inputs=self.inputs.values(), capture_ms=capture_ms, pool_bytes=pool_bytes,
        )
        return result

    def call(self, values: Dict[str, torch.Tensor], events: Optional[Tuple[Any, Any]] = None) -> Any:
        from torchmetrics_tpu_torch import ops

        with torch.no_grad():
            for k, buf in self.inputs.items():
                buf.copy_(values[k])
            device = next(iter(self.inputs.values())).device if self.inputs else torch.device("cpu")
            with timed_replay(self.scope, device, events):
                if self.graph is None:
                    return self.fn(self.inputs, False)
                self.graph.replay()
            ops.add_launches(self.launches)
            return self.outputs


class _ComputeTimer:
    """The diagnostics of one compute dispatch: timing from the dispatch start, the
    sampled probe, the ``compute.*`` events and histograms, the build attribution."""

    __slots__ = ("stats", "rec", "profiling", "measuring", "t0", "probing", "events")

    def __init__(self, stats: EngineStats, first: bool, device: torch.device) -> None:
        self.stats = stats
        self.rec = _diag.active_recorder()
        self.profiling = _profile.active_profile() is not None
        self.measuring = self.rec is not None or self.profiling
        self.probing = self.profiling and not first and _profile.probe_due(stats.owner, "compute")
        self.events = probe_events(device) if self.probing else None
        self.t0 = perf_counter() if self.measuring else 0.0

    def finish(
        self, metric: Any, first: bool, fused: bool, fps: Dict[Tuple, Dict[str, Any]], key: Tuple,
        fp: Dict[str, Any], coverage: Optional[Dict[str, Any]] = None,
    ) -> None:
        st = self.stats
        device_us = event_us = None
        if self.probing:
            device_us, event_us = completion_probe(st.owner, "compute", st, self.t0, self.events)
        if first:
            note_build(st, "compute", fps, key, fp, fused=fused)
        # a compute result is an observation of the folded watermark
        prov = _lineage.observe_metric(metric, "compute", coverage=coverage)
        if not self.measuring:
            return
        dispatch_us = round((perf_counter() - self.t0) * 1e6, 3)
        _hist.observe(st.owner, "compute", "dispatch_us", dispatch_us)
        _hist.observe(st.owner, "compute", "compute_us", dispatch_us)
        if self.rec is not None:
            span = {} if prov is None or prov.span is None else {"lineage": prov.span}
            self.rec.record("compute.dispatch", st.owner, dispatch_us=dispatch_us, fused=fused, cached=not first, **span)
            if device_us is not None:
                probe = {"device_event_us": event_us} if event_us is not None else {}
                self.rec.record("compute.probe", st.owner, dispatch_us=dispatch_us, device_us=device_us, **probe)


def _compute_fingerprint(key: Tuple, sentinel: bool) -> Dict[str, Any]:
    """A compute signature's aspects for retrace attribution (the sentinel joins the
    treedef: toggling it reads as ``treedef-change``)."""
    return {
        "treedef": (tuple(k for k, *_ in key), sentinel),
        "dtype": tuple(str(d) for _, _, d, _ in key),
        "shape": tuple(sh for _, sh, _, _ in key),
        "device": tuple(sorted({str(dev) for *_, dev in key})),
    }


def _plan_fingerprint(plan: PackedSyncPlan) -> Dict[str, Any]:
    """A packed plan's aspects for retrace attribution of its fused compute."""
    return {
        "treedef": tuple((s.owner, s.attr, s.kind, s.was_list) for s in plan.specs),
        "dtype": tuple(s.dtype for s in plan.specs),
        "shape": tuple((s.shape, s.elem_shapes, s.world_dim0) for s in plan.specs),
        "plan": (plan.world_size, plan.members, tuple(sorted(plan._group_sizes.items()))),
    }


class EpochEngine:
    """Packed sync, cached compute and the fused sync-and-compute for one metric; made
    at first use and left out of pickles."""

    def __init__(self, metric: Any) -> None:
        self._metric = metric
        self.stats = EngineStats("epoch:" + type(metric).__name__)
        self._fold_cache: Dict[Tuple, Callable] = {}
        self._compute_cache: Dict[Tuple, Any] = {}
        self._fused_cache: Dict[Tuple, Any] = {}
        self._compute_fps: Dict[Tuple, Dict[str, Any]] = {}  # built keys, for retrace attribution
        self._fused_fps: Dict[Tuple, Dict[str, Any]] = {}
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

    def _build(self, cache: Dict[Tuple, Any], key: Tuple, call: _GraphCall, device: torch.device, prefix: str, kind: str) -> Tuple[bool, Any]:
        """Build ``call`` for ``key``: ``(True, first result)``, or ``(False, None)`` with
        the key demoted (counted) when the guard refuses it or it fails to build."""
        from torchmetrics_tpu_torch.engine import txn

        try:
            result = call.build(self._graph_pool(device), device, self.stats.owner, kind, key)
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
        (counted) to run it eagerly. With the sentinel on, the value's NaN / ±Inf checks
        fold into the metric's bitmask inside the same graph."""
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
        flags = m.__dict__.get(_sentinel.ATTR) if _sentinel.sentinel_enabled() else None
        sig = state_signature(state)
        key = (sig, flags is not None)
        call = self._compute_cache.get(key)
        if call is _FALLBACK:
            st.fallback("compute:uncompilable-signature")
            return False, None
        first = call is None
        timer = _ComputeTimer(st, first, m.device)
        values = dict(state)
        if flags is not None:
            values[_sentinel.STATE_KEY] = flags
        if first:

            def fn(inputs: Dict[str, torch.Tensor], check: bool) -> Any:
                value = traced_compute(m, inputs, check)
                if _sentinel.STATE_KEY in inputs:
                    return value, _sentinel.value_flags(inputs[_sentinel.STATE_KEY], value, m)
                return value, None

            call = _GraphCall({k: v.clone(memory_format=torch.contiguous_format) for k, v in values.items()}, fn)
            built, result = self._build(self._compute_cache, key, call, m.device, "compute", "compute")
            if not built:
                return False, None
        else:
            result = call.call(values, timer.events)
            st.compute_cache_hits += 1
        value, flags_out = result
        if flags_out is not None:
            flags.copy_(flags_out)
        st.compute_dispatches += 1
        timer.finish(m, first, False, self._compute_fps, key, _compute_fingerprint(sig, flags is not None))
        return True, _owned(value)

    def sync_and_compute(self) -> Optional[tuple]:
        """The fused route: the packed exchange, then one graph doing the fold and the
        compute (and the sentinel's value checks). None when the states cannot be packed
        (the caller goes eager); else a 1-tuple of the value (``NO_VALUE`` when the
        compute half falls back and runs on the synced states), the synced states
        written onto the metric."""
        m = self._metric
        st = self.stats
        try:
            plan = PackedSyncPlan([("", m)], *_sync_scope([("", m)]))
        except PackingError as exc:
            st.fallback(f"sync:{exc}")
            return None
        gathered, plan = _exchange(plan, st)
        key = ("fused", plan.signature())
        call = self._fused_cache.get(key)
        if call is _FALLBACK or not self._compute_ok:
            return self._fold_then_no_value(plan, gathered)
        first = call is None
        timer = _ComputeTimer(st, first, m.device)
        if first:
            fold = plan.make_fold()

            def fn(inputs: Dict[str, torch.Tensor], check: bool) -> Any:
                states = fold(inputs).get("", {})
                value = traced_compute(m, states, check)
                if _sentinel.ATTR in states:
                    # the value's health folds into the (already ORed) bitmask
                    states = dict(states)
                    states[_sentinel.ATTR] = _sentinel.value_flags(states[_sentinel.ATTR], value, m)
                return states, value

            call = _GraphCall({k: v.clone() for k, v in gathered.items()}, fn)
            built, result = self._build(self._fused_cache, key, call, m.device, "compute", "sync-compute")
            if not built:
                return self._fold_then_no_value(plan, gathered)
        else:
            result = call.call(gathered, timer.events)
            st.compute_cache_hits += 1
        states, value = _owned(result)
        st.compute_dispatches += 1
        st.packed_syncs += 1
        _note_plan_coverage(st, plan)
        partial = plan.degraded or len(plan.members) != plan.world_size
        timer.finish(m, first, True, self._fused_fps, key, _plan_fingerprint(plan), plan.coverage() if partial else None)
        _write_synced(m, states, plan, "")
        return (value,)

    def _fold_then_no_value(self, plan: PackedSyncPlan, gathered: Dict[str, torch.Tensor]) -> tuple:
        """The fold alone, for an exchange whose compute cannot fuse."""
        folded = _run_fold(plan, gathered, self._fold_cache)
        _write_synced(self._metric, folded.get("", {}), plan, "")
        self.stats.packed_syncs += 1
        _note_plan_coverage(self.stats, plan)
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
