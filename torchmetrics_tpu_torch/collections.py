"""MetricCollection with compute groups (counterpart of ``torchmetrics_tpu/collections.py``).

A dict of metrics with one call pattern. Metrics whose states are provably identical
form a compute group:

- **Canonical state + views.** Each ``_ComputeGroup`` names one member, the first, as
  the owner of the group's state; only the owner runs ``update``. The other members
  are views that receive the owner's state when someone looks at them (``items`` /
  ``values`` / ``[]`` / ``compute``). The port's states are re-bound on every update
  and never written in place, so a view may share the owner's tensors; with
  ``copy_state=True`` it gets clones, lists and tensors alike.
- **Signature fusion (CSE) when the collection is built.** Members that declare an
  equal ``reduction_signature`` (``engine/statespec.py``) merge at once: macro,
  weighted and none accuracy over the same stat scores run one update, so kernel K1
  launches once per collection ``update``, not once per member.
- **Value discovery at the first step** for members without a signature: after the
  first ``update``, groups whose owners hold equal states merge, unless their
  declared signatures differ (the veto).
- **Packed compute sync.** ``compute`` syncs every group owner in one
  ``PackedSyncPlan`` exchange (``engine/epoch.py``) before the members compute.

- **Fused dispatch.** With the engine on (``fused_dispatch=None`` follows the engine
  policy, ``True`` forces it), every fusable group owner's update runs in ONE captured
  CUDA graph per step (``engine/fusion.py``); owners it excludes update on their own.
  After a fused step the views re-anchor on the owners' static buffers, which later
  replays update in place, so a retained member handle keeps reading live state.

- **Scan and async.** ``scan_steps=K`` (or ``TORCHMETRICS_TPU_SCAN``) queues the fused
  step on the fused engine's ``FusedScan`` (``engine/scan.py``): K steps fold in one
  replay of a K-step graph, owners the probe refuses (the binned curves) update
  eagerly beside it. ``async_dispatch`` moves the drains to a background worker
  (``engine/async_dispatch.py``). Every observation (``forward``, ``compute``,
  ``state_dict``, ``load_state_dict``, ``clone``, ``to``, ``set_dtype``,
  ``state_footprint``, a membership change) drains first and ``reset`` discards; a
  drain re-anchors the views. Under ``TORCHMETRICS_TPU_QUARANTINE=error`` the batch is
  admitted once for every owner before any state moves.

``forward`` runs every member's own ``forward``, owners and views alike.
``fused_dispatch=False`` turns the fused step and the packed compute sync off, as the
engine being off does in the JAX package.

With a recorder or a profile observing, a settled ``update`` records a
``collection.step`` event (``dispatch_us``, ``owners``, ``fused``) and feeds the
``collection`` ``dispatch_us`` histogram; the one-time group discovery reads the states
inside ``transfer_allowed("group-discovery")``. The members' sentinels, quarantine
counters and compensation residuals ride the fused step and the packed sync.

Left out against the JAX package: ``persist`` and ``snapshot_compute`` (``serve/``).
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from copy import deepcopy
from time import perf_counter
from typing import Any, Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import profile as _profile
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine import txn
from torchmetrics_tpu_torch.engine.async_dispatch import coerce_inflight, resolve_async
from torchmetrics_tpu_torch.engine.config import engine_enabled
from torchmetrics_tpu_torch.engine.fusion import FusedUpdate
from torchmetrics_tpu_torch.engine.scan import coerce_k, discard_metrics, flush_metrics, scan_k
from torchmetrics_tpu_torch.engine.statespec import cse_enabled, reduction_signature
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import allclose
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _copied(value: Any) -> Any:
    if isinstance(value, list):
        return [v.clone() for v in value]
    return value.clone()


class _ComputeGroup:
    """A set of metric names whose states are provably identical.

    The first name is the owner: the only member whose ``update`` runs, and whose
    states are the group's single source of truth.
    """

    __slots__ = ("names",)

    def __init__(self, names: Sequence[str]) -> None:
        self.names: List[str] = list(names)

    @property
    def owner(self) -> str:
        return self.names[0]

    def absorb(self, other: "_ComputeGroup") -> None:
        self.names.extend(other.names)

    def materialize_views(self, modules: Dict[str, Metric], copy: bool = False) -> None:
        """Push the owner's states into every view member (clones when ``copy``)."""
        owner = modules[self.owner]
        owner_ref = weakref.ref(owner)
        for name in self.names[1:]:
            view = modules[name]
            for state in owner._defaults:
                value = getattr(owner, state)
                setattr(view, state, _copied(value) if copy else value)
            view._update_count = owner._update_count
            view._computed = None
            # a view observes its owner's state: its observations drain the owner's
            # queue (a view never queues itself)
            view._scan_peer = owner_ref
            # fold markers travel with the states they describe
            view._none_folded = set(owner._none_folded)


def _state_fingerprint(metric: Metric) -> Optional[tuple]:
    """Structural digest of a metric's registered states (names, kinds, shapes, dtypes);
    ``None`` if stateless. Only metrics with equal fingerprints are compared by value."""
    if not metric._defaults:
        return None
    sig = []
    for key in sorted(metric._defaults):
        val = getattr(metric, key)
        if isinstance(val, list):
            sig.append((key, "list", tuple((tuple(v.shape), str(v.dtype)) for v in val)))
        else:
            sig.append((key, "tensor", tuple(val.shape), str(val.dtype)))
    return tuple(sig)


def _states_equal(metric1: Metric, metric2: Metric) -> bool:
    """Value equality of two structurally identical metrics' states (reads them on the
    host, inside the sanctioned ``group-discovery`` boundary: it runs once, at the first
    step's discovery)."""
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    with transfer_allowed("group-discovery"):
        for key in metric1._defaults:
            state1 = getattr(metric1, key)
            state2 = getattr(metric2, key)
            if isinstance(state1, list):
                if not all(allclose(s1, s2) for s1, s2 in zip(state1, state2)):
                    return False
            elif not allclose(state1, state2):
                return False
    return True


class MetricCollection:
    """Dict of metrics sharing one call pattern, with automatic compute groups.

    Args:
        metrics: a Metric or MetricCollection, a sequence of them, or a name -> metric dict.
        prefix: string prepended to every result key.
        postfix: string appended to every result key.
        compute_groups: True (discover automatically), False (off), or an explicit
            list of name groups.
        fused_dispatch: ``None`` (follow the engine policy, on for CUDA metrics), ``True``
            (force the one-graph fused step on) or ``False`` (fused step and packed
            compute sync off).
        scan_steps: ``None`` (follow ``TORCHMETRICS_TPU_SCAN`` / ``scan_context``), ``0`` /
            ``False`` (off) or K in [2, 1024]: queue K fused steps per graph replay.
        async_dispatch: ``None`` (follow ``TORCHMETRICS_TPU_ASYNC``), ``False`` / ``0``
            (off), ``True`` or an in-flight bound in [1, 16]: drain on a background worker.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricCollection
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassConfusionMatrix
        >>> metrics = MetricCollection(
        ...     {"acc": MulticlassAccuracy(num_classes=3, device="cpu"),
        ...      "cm": MulticlassConfusionMatrix(num_classes=3, device="cpu")})
        >>> out = metrics(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]))
        >>> round(float(out["acc"]), 4), out["cm"].tolist()
        (0.8333, [[1, 1, 0], [0, 1, 0], [0, 0, 1]])
    """

    _groups: Dict[int, _ComputeGroup]
    # > 0 while a step or a drain is changing member states (the fused step bumps the
    # owners' counts outside their update wrappers): parallel/elastic.py's signal-time
    # snapshot stands on the last flush then
    _mutation_depth = 0

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        fused_dispatch: Optional[bool] = None,
        scan_steps: Optional[int] = None,
        async_dispatch: Optional[Any] = None,
    ) -> None:
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        if fused_dispatch is not None and not isinstance(fused_dispatch, bool):
            raise ValueError(f"Expected `fused_dispatch` to be a bool or None but got {fused_dispatch}")
        self.fused_dispatch = fused_dispatch
        self.scan_steps = coerce_k(scan_steps)
        self.async_dispatch = coerce_inflight(async_dispatch)
        self._groups_checked: bool = False
        self._state_is_copy: bool = False
        self._epoch_sync = None  # engine/epoch.py CollectionEpoch, made at the first packed compute
        self._fused_engine = None  # engine/fusion.py FusedUpdate, made at the first fused step
        self._cse_signatures: Dict[str, Optional[tuple]] = {}

        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------ update paths

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every member's own ``forward`` (batch values); kwargs filtered per signature."""
        self._drain_scan("observation:forward")
        return self._compute_and_reduce("forward", *args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """One collection step: each group owner accumulates the batch once.

        Before the groups are settled, the first step runs every group's owner (every
        member, with ``compute_groups=False``) and then discovers groups by value.
        Members already merged by signature do not run: the owner's state replaces
        theirs once discovery ends.
        """
        self._mutation_depth += 1
        try:
            self._update(args, kwargs)
        finally:
            self._mutation_depth -= 1

    def _update(self, args: tuple, kwargs: dict) -> None:
        if self._groups_checked:
            rec = _diag.active_recorder()
            measuring = rec is not None or _profile.active_profile() is not None
            t_step = perf_counter() if measuring else 0.0
            owners = [(group.owner, self._modules[group.owner]) for group in self._groups.values()]
            prechecked = txn.quarantine_error()
            if prechecked:
                # the fused step bypasses the members' update wrappers: admit the batch
                # for every owner before any state can change
                placed = tuple(owners[0][1]._place(a) for a in args) if owners else args
                for _, owner in owners:
                    txn.admission_check_or_raise(owner, placed, owner._filter_kwargs(**kwargs))
            handled, scan_active = self._fused_step(owners, args, kwargs)
            for name, owner in owners:
                if name not in handled:
                    if prechecked:
                        owner._admission_prechecked = True
                    owner.update(*args, **owner._filter_kwargs(**kwargs))
                    sq = owner._engine._scan if owner._engine is not None else None
                    if sq is not None and sq.on_drain is None:
                        # an owner queueing on its own engine re-anchors the views
                        # when its queue drains, wherever the drain fires
                        sq.on_drain = self._anchor_views_after_scan
            if measuring:
                step_us = round((perf_counter() - t_step) * 1e6, 3)
                _hist.observe(type(self).__name__, "collection", "dispatch_us", step_us)
                if rec is not None:
                    rec.record("collection.step", type(self).__name__, dispatch_us=step_us, owners=len(owners), fused=len(handled))
            if scan_active:
                # a queued step changes no buffer binding: each drain re-anchors
                if self._state_is_copy:
                    self._materialize_group_views()
            elif handled or any(owner._engine is not None for _, owner in owners):
                # re-anchor the views NOW on the owners' static buffers: a member
                # handle retained from an earlier accessor keeps reading live state
                self._state_is_copy = False
                self._materialize_group_views()
            elif self._state_is_copy:
                # the views hold copies of the old state; the next accessor re-anchors
                self._materialize_group_views()
            return
        if self._enable_compute_groups:
            members = [self._modules[group.owner] for group in self._groups.values()]
        else:
            members = list(self._modules.values())
        # the discovery step runs eagerly: a graph for members that become views (or
        # fused owners) one step later is pure waste
        discovering = bool(self._enable_compute_groups)
        for metric in members:
            prior = metric.compiled_update
            if discovering:
                metric.compiled_update = False
            try:
                metric.update(*args, **metric._filter_kwargs(**kwargs))
            finally:
                metric.compiled_update = prior
        if self._enable_compute_groups:
            self._discover_groups()
            self._materialize_group_views()
            self._groups_checked = True

    def _fused_step(self, owners: List[Tuple[str, Metric]], args: tuple, kwargs: dict) -> Tuple[set, bool]:
        """Try the one-graph fused step over the group owners, queued when a scan depth
        is active: ``(names handled, scan active)``. The scan knob is read only where
        the engine is on."""
        enabled = self.fused_dispatch
        if enabled is None:
            enabled = bool(owners) and engine_enabled(owners[0][1].device)
        k = self._scan_depth() if enabled else None
        fe = self._fused_engine
        stale = fe is not None and [n for n, _ in fe.metrics] != [n for n, _ in owners]
        if fe is not None and (k is None or stale) and fe._scan is not None and fe._scan.pending:
            # leftover steps (a closed scope, the engine turned off, an owner set about
            # to change) drain before anything else applies
            fe._scan.drain("scan-disabled" if not stale else "signature-change")
        if not enabled or len(owners) < 2:
            return set(), k is not None
        if fe is None or stale:
            fe = self._fused_engine = FusedUpdate(owners)
            fe.on_scan_drain = self._anchor_views_after_scan
        # the inputs onto the owners' device, as each owner's own update places them
        place = owners[0][1]._place
        placed = tuple(place(a) for a in args)
        if k is not None:
            handled = fe.scan_step(placed, kwargs, k, resolve_async(self.async_dispatch))
            return (handled if handled is not None else set()), True
        return fe.step(placed, kwargs), False

    def _scan_depth(self) -> Optional[int]:
        """The active scan queue depth for this collection, or None (unqueued)."""
        if self.scan_steps is not None:
            return self.scan_steps or None  # 0 = forced off
        return scan_k()

    def _anchor_views_after_scan(self) -> None:
        if self._groups_checked:
            self._state_is_copy = False
            self._materialize_group_views()

    def _drain_scan(self, reason: str) -> int:
        """Drain the fused queue and every member's own queue before member states are
        read, then re-anchor the views."""
        self._mutation_depth += 1
        try:
            drained = flush_metrics(list(self._modules.values()), reason)
            if drained:
                self._anchor_views_after_scan()
        finally:
            self._mutation_depth -= 1
        return drained

    # ------------------------------------------------------------------ group discovery

    def _discover_groups(self) -> None:
        """Merge groups whose owners' states are equal, in one pass.

        Candidates bucket by structural fingerprint; within a bucket each group folds
        into the first representative whose state values match, else becomes one.
        Groups that declared a reduction signature merged when the collection was
        built; here a signature is a veto: two groups whose declared reductions differ
        never merge by a first-batch coincidence of values.
        """
        sigs = self._cse_signatures
        merged: List[_ComputeGroup] = []
        buckets: Dict[tuple, List[_ComputeGroup]] = {}
        for group in self._groups.values():
            owner = self._modules[group.owner]
            fingerprint = _state_fingerprint(owner)
            if fingerprint is None:  # stateless metrics never share a group
                merged.append(group)
                continue
            sig = sigs.get(group.owner)
            for representative in buckets.setdefault(fingerprint, []):
                rep_sig = sigs.get(representative.owner)
                if sig is not None and rep_sig is not None and sig != rep_sig:
                    continue  # declared reductions differ: a value match is a coincidence
                if _states_equal(self._modules[representative.owner], owner):
                    representative.absorb(group)
                    break
            else:
                buckets[fingerprint].append(group)
                merged.append(group)
        self._groups = dict(enumerate(merged))

    def _materialize_group_views(self, copy: bool = False) -> None:
        """Push the owners' states into every group's view members."""
        if not self._state_is_copy:
            for group in self._groups.values():
                group.materialize_views(self._modules, copy=copy)
        self._state_is_copy = copy

    # ------------------------------------------------------------------ compute

    def compute(self) -> Dict[str, Any]:
        """Every member's ``compute`` into one flat (renamed) dict.

        Across processes, every eligible group owner syncs first in one packed
        exchange (one metadata gather when needed plus one collective per buffer, for
        the whole collection); then each member computes on the synced states and the
        owners unsync.
        """
        self._drain_scan("observation:compute")
        restore = self._packed_epoch_sync()
        try:
            return self._compute_and_reduce("compute")
        finally:
            restore()

    def _packed_epoch_sync(self) -> Callable[[], None]:
        """Pack-sync the group owners ahead of the member compute pass.

        Returns a restore callable (always safe to call) that re-enables each
        member's own sync and unsyncs any owner the member pass left synced.
        """

        def noop() -> None:
            return None

        if self.fused_dispatch is False:
            return noop
        if self._groups_checked and self._groups:
            owners = [(group.owner, self._modules[group.owner]) for group in self._groups.values()]
        else:
            owners = list(self._modules.items())
        eligible = []
        for name, m in owners:
            # per-metric opt-outs and what needs its own sync semantics (a custom
            # gather, host list states, a sub-world group) sync themselves
            if not m._to_sync or m._is_synced or m.dist_sync_fn is not None:
                continue
            if m.compute_on_cpu or m.process_group is not None:
                continue
            available = m.distributed_available_fn
            if callable(available) and available():
                eligible.append((name, m))
        if len(eligible) < 2:
            return noop
        from torchmetrics_tpu_torch.engine.epoch import CollectionEpoch

        names = [n for n, _ in eligible]
        if self._epoch_sync is None or self._epoch_sync.names != names:
            self._epoch_sync = CollectionEpoch(names)
        snapshots = {name: m._copy_state_refs() for name, m in eligible}
        if not self._epoch_sync.packed_sync(eligible):
            return noop
        for name, m in eligible:
            m._cache = snapshots[name]
            m._is_synced = True
        # turn each member's own sync off only where the packed exchange covered it:
        # the synced owners and their views (which receive the owners' world state)
        packed_owners = set(names)
        if self._groups_checked and self._groups:
            covered = {n for group in self._groups.values() if group.owner in packed_owners for n in group.names}
        else:
            covered = packed_owners
        disabled = []
        for name, m in self._modules.items():
            if name in covered and m._to_sync:
                m._to_sync = False
                disabled.append(m)
        self._state_is_copy = False  # re-anchor the views onto the synced owners

        def restore() -> None:
            for m in disabled:
                m._to_sync = True
            for _, m in eligible:
                if m._is_synced:  # the member pass normally unsyncs owners itself
                    m.unsync()
            self._state_is_copy = False  # the next accessor re-anchors local state

        return restore

    def _compute_and_reduce(self, method_name: str, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        if method_name not in ("compute", "forward"):
            raise ValueError(f"method_name should be either 'compute' or 'forward', but got {method_name}")
        result = {}
        for name, metric in self.items(keep_base=True, copy_state=False):
            if method_name == "compute":
                res = metric.compute()
            else:
                res = metric(*args, **metric._filter_kwargs(**kwargs))
            if isinstance(res, dict):
                for key, value in res.items():
                    if getattr(metric, "prefix", None) is not None:
                        key = f"{metric.prefix}{key}"
                    if getattr(metric, "postfix", None) is not None:
                        key = f"{key}{metric.postfix}"
                    result[key] = value
            else:
                result[name] = res
        return {self._set_name(k): v for k, v in result.items()}

    # ------------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        """Reset every metric; group views re-anchor to the (reset) owners. The fused
        queue's steps are discarded with the states they would have moved."""
        discard_metrics(list(self._modules.values()), "reset")
        for metric in self.values(copy_state=False):
            metric.reset()
        if self._enable_compute_groups and self._groups_checked:
            self._materialize_group_views()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy, optionally re-prefixed."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def __getstate__(self) -> Dict[str, Any]:
        """The sync and fused engines belong to the instance: never pickled or copied.
        The fused queue's steps fold into the owners first."""
        self._drain_scan("observation:clone")
        state = self.__dict__.copy()
        state["_epoch_sync"] = None
        state["_fused_engine"] = None
        return state

    def persistent(self, mode: bool = True) -> None:
        """Toggle state persistence for all metrics."""
        for metric in self.values(copy_state=False):
            metric.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        """Flat state dict keyed ``"<member>.<state>"``."""
        self._drain_scan("observation:state_dict")
        destination: Dict[str, Any] = {}
        for name, metric in self.items(keep_base=True, copy_state=False):
            metric.state_dict(destination, prefix=f"{name}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        """Restore from ``state_dict`` (or from ``interop.collection_state_from_jax``)."""
        self._drain_scan("observation:load_state_dict")
        for name, metric in self.items(keep_base=True, copy_state=False):
            metric.load_state_dict(state_dict, prefix=f"{name}.")

    def state_footprint(self) -> Dict[str, Any]:
        """Bytes held by the member states; ``unique_bytes`` counts once a buffer that
        compute-group views share with their owner (``diag/costs.py``)."""
        self._drain_scan("observation:state_footprint")
        self._materialize_group_views()
        from torchmetrics_tpu_torch.diag.costs import state_footprint

        return state_footprint(self)

    # ------------------------------------------------------------------ membership

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Register metrics from a dict, a sequence or one instance. A membership change
        drops the fused engine: its queued steps fold into the members first."""
        if getattr(self, "_modules", None):
            self._drain_scan("observation:membership-change")
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                rank_zero_warn(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        v.postfix = metric.postfix
                        v.prefix = metric.prefix
                        self._modules[f"{name}_{k}"] = v
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if not isinstance(metric, (Metric, MetricCollection)):
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self._modules:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self._modules[name] = metric
                else:
                    for k, v in metric.items(keep_base=False):
                        v.postfix = metric.postfix
                        v.prefix = metric.prefix
                        self._modules[k] = v
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected, `Metric`, `MetricCollection` or `dict`/`sequence` of the"
                f" previous, but got {metrics}"
            )

        self._groups_checked = False
        if self._enable_compute_groups:
            self._init_compute_groups()
        else:
            self._groups = {}

    def _init_compute_groups(self) -> None:
        """Seed groups: the user's lists, or one singleton per metric, then merged by
        declared reduction signature."""
        if isinstance(self._enable_compute_groups, list):
            for names in self._enable_compute_groups:
                for metric in names:
                    if metric not in self._modules:
                        raise ValueError(
                            f"Input {metric} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules.keys())}"
                        )
            self._groups = {i: _ComputeGroup(names) for i, names in enumerate(self._enable_compute_groups)}
            self._groups_checked = True
        else:
            self._groups = {i: _ComputeGroup([str(k)]) for i, k in enumerate(self._modules.keys())}
            self._merge_cse_groups()

    def _merge_cse_groups(self) -> None:
        """Merge members with an equal reduction signature, when the collection is built.

        Equal signatures prove identical update bodies, not identical accumulated
        state: only members still at their defaults merge this way (a pre-updated
        metric keeps the value discovery, which refuses the merge). When every member
        has a signature and is fresh, discovery is done here and the first step
        already runs one update per group.
        """
        if not cse_enabled():
            self._cse_signatures = {}
            return
        sigs = {name: reduction_signature(m) for name, m in self._modules.items()}
        self._cse_signatures = sigs
        fresh = {name: self._metric_state_is_default(m) for name, m in self._modules.items()}
        merged: List[_ComputeGroup] = []
        by_sig: Dict[tuple, _ComputeGroup] = {}
        for group in self._groups.values():
            sig = sigs.get(group.owner)
            if sig is None or not fresh.get(group.owner, False):
                merged.append(group)
                continue
            representative = by_sig.get(sig)
            if representative is None:
                by_sig[sig] = group
                merged.append(group)
            else:
                representative.absorb(group)
        self._groups = dict(enumerate(merged))
        if self._groups and all(sigs[name] is not None and fresh[name] for name in self._modules):
            self._groups_checked = True
            self._materialize_group_views()

    @staticmethod
    def _metric_state_is_default(metric: Metric) -> bool:
        """Never updated, never synced, every state still the one ``add_state`` or
        ``reset`` put there (the freshness marker) and every list empty. Host-side only."""
        if metric._update_count != 0 or metric._is_synced or not metric._state_fresh:
            return False
        return not any(isinstance(v, list) and v for v in (getattr(metric, a) for a in metric._defaults))

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        """Current compute groups as ``{index: [member names]}``."""
        return {i: list(group.names) for i, group in self._groups.items()}

    # ------------------------------------------------------------------ dict protocol

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> OrderedDict:
        od = OrderedDict()
        for k, v in self._modules.items():
            od[self._set_name(k)] = v
        return od

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._modules)

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self, keep_base: bool = False) -> Iterable[Hashable]:
        """Metric names (renamed unless ``keep_base``)."""
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        """(name, metric) pairs; materializes the group views first."""
        self._materialize_group_views(copy_state)
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        """Metrics; materializes the group views first."""
        self._materialize_group_views(copy_state)
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        """Metric by (renamed) key."""
        self._materialize_group_views(copy_state)
        if self.prefix or self.postfix:
            key = key.removeprefix(self.prefix or "").removesuffix(self.postfix or "")
        return self._modules[key]

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        for k, v in self._modules.items():
            repr_str += f"\n  {k}: {v!r}"
        if self.prefix:
            repr_str += f",\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f",\n  postfix={self.postfix}"
        return repr_str + "\n)"

    def to(self, device: Union[str, torch.device]) -> "MetricCollection":
        """Move all metric states to ``device``."""
        self._drain_scan("observation:device-move")
        for metric in self.values(copy_state=False):
            metric.to(device)
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "MetricCollection":
        """Cast the floating states of every metric."""
        self._drain_scan("observation:set_dtype")
        for metric in self.values(copy_state=False):
            metric.set_dtype(dst_type)
        return self

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None, together: bool = False) -> Any:
        """Plot every metric: in one figure (``together``) or one figure each."""
        if val is None:
            val = self.compute()
        if together:
            from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

            return plot_single_or_multi_val(val, ax=ax)
        return [
            m.plot(val[k] if isinstance(val, dict) and k in val else None)
            for k, m in self.items(keep_base=False, copy_state=False)
        ]
