"""The ``Metric`` base class on PyTorch (counterpart of ``torchmetrics_tpu/metric.py``).

Follows the upstream torchmetrics design: a ``torch.nn.Module`` whose states are
tensors (or lists of tensors for unbounded "cat" states) registered with
``add_state`` and tracked in ``_defaults`` / ``_reductions``. States live on the
metric's ``device``; ``update`` places its tensor inputs there with
``torch.as_tensor``.

``device=None`` means ``torch.device("cuda")``: a metric is built for the card and
refuses to run elsewhere unless the caller asks for ``device="cpu"``.

``update`` goes through the compiled update engine (``engine/compiled.py``: one CUDA
graph replay per step) whenever the engine is on for the metric: ``compiled_update=True``,
or ``None`` (the default) with the process-wide policy on, which it is by default for a
metric on a CUDA device (``engine/config.py``). Updates the engine cannot run as a
graph fall back to the eager path, counted with their reason in ``EngineStats``.

``sync`` (and so ``compute`` across processes) takes the packed route of
``engine/epoch.py`` unless a ``dist_sync_fn`` is given, ``compute_on_cpu`` is on or a
sub-world ``process_group`` is named: those take the eager per-tensor path, counted as
a fallback. The JAX package gates the packed route on its engine policy; the port
always takes it.

Arithmetic on metrics (``metric + 1``, ``1 - acc``, ``a @ b``, ``abs(m)``, ``m[0]``)
builds a lazy ``CompositionalMetric``. ``set_dtype`` is the only cast of the states:
``float`` / ``double`` / ``half`` / ``type`` are no-ops, as in the JAX package, and
override ``torch.nn.Module``'s casts. ``__eq__`` composes too, so ``Metric`` defines
``__hash__`` from the class and the identities of the metric and its states: the hash
changes when a state is replaced, and no code of the package keys a dict or a set by
a metric.

``scan_steps`` (``engine/scan.py``: K queued steps folded by one replay of a K-step
graph) and ``async_dispatch`` (``engine/async_dispatch.py``: those drains on a
background worker) take the JAX package's values and errors; every state observation
(``forward``, ``compute``, ``sync``, ``merge_state``, ``state_dict``,
``load_state_dict``, ``clone``, ``to``, ``set_dtype``, ``state_footprint``) drains the
queue first and ``reset`` discards it. ``TORCHMETRICS_TPU_QUARANTINE``
(``engine/txn.py``) and ``TORCHMETRICS_TPU_COMPENSATED`` (``engine/numerics.py``) add
their riders to the eager path and to every graph; ``compute`` reads the quarantine
counter and re-anchors the compensated sums. With the engine on, ``compute`` runs as a
cached graph per state signature (``engine/epoch.py``), and across processes as the
packed exchange plus one graph for the fold and the compute.

The diagnostics (``diag/``) ride along: ``update``, ``forward`` and ``compute`` called
on their own are ``api.*`` spans (``diag/trace.py``), an eager update an
``eager.update`` span and a compute an ``epoch.compute`` one; an eager update records
``update.eager`` (its span's duration; it feeds the ``eager`` ``dispatch_us``
histogram) while a recorder or a profile observes,
an eager per-tensor sync records ``sync.eager``, ``reset`` zeroes the health sentinel in
place (``diag/sentinel.py``; a replay may hold it as a static buffer), and a
``compute`` through the epoch engine attaches its ``ValueProvenance`` as
``_provenance`` (``diag/lineage.py``). ``_rank_invariant_states`` names the states the
divergence audit expects equal on every rank.

``snapshot_compute`` computes on a copy of the state taken while updates go on
(``serve/snapshot.py``). ``add_state`` registers each state's ``StateSpec``
(``engine/statespec.py``; ``state_specs`` lists them), with the packed-sync roles the
serving states declare in ``spec=`` (``engine/statespec.validate_role_spec``).

Sharded state (``parallel/sharding.py``): under an active state mesh a state whose rule
resolves to a partition is born a ``DTensor`` holding this rank's block. The update body
and the engines run on the local blocks; ``sync`` skips such a state on a 1-D mesh and
folds it over the ``data`` sub-group on a 2-D one (the replicated states then sync over
that sub-group too); ``compute`` runs on the assembled whole states; ``state_dict``
writes them whole, and ``load_state_dict`` and unpickling re-place them
(``_apply_shard_rules``).

``engine/persist.prewarm`` builds a fresh metric's graphs from a signature manifest before
its first update, on zero inputs, and puts every state back into the buffers the graphs
hold; ``warm_start`` then restores the newest snapshot (``parallel/elastic.py``).
"""

from __future__ import annotations

import functools
import inspect
import threading
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.diag import sentinel as _sentinel
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine import numerics, txn
from torchmetrics_tpu_torch.engine.async_dispatch import coerce_inflight, resolve_async
from torchmetrics_tpu_torch.engine.compiled import CompiledUpdate, detach_from_static, is_static
from torchmetrics_tpu_torch.engine.config import engine_enabled
from torchmetrics_tpu_torch.engine.scan import coerce_k, discard_metric, flush_metric, scan_k
from torchmetrics_tpu_torch.engine.statespec import build_spec, register_state_spec, specs_of, state_fold, validate_role_spec
from torchmetrics_tpu_torch.parallel import sharding as _sharding
from torchmetrics_tpu_torch.parallel.packing import shape_fingerprint
from torchmetrics_tpu_torch.parallel.sync import distributed_available, gather_all_tensors
from torchmetrics_tpu_torch.utilities.data import (
    _flatten,
    _squeeze_if_scalar,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_REDUCTIONS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


#: hands a snapshot a moment with no mutation in flight (``serve/snapshot.py``), and
#: the next mutation its turn after it. Polling the depth alone starves the snapshot
#: against a back-to-back loop: its torch calls release the interpreter lock
#: mid-update, so a poller almost always finds an update in flight. Every change of
#: a ``_Gate`` happens under this condition.
_QUIESCE = threading.Condition()
#: the longest a mutation waits for snapshots; past it the mutation goes on and the
#: snapshot's watermark check retries
_YIELD_TIMEOUT_S = 10.0
#: ``ids``: the owners this thread holds off; its own mutations of them do not wait
_HOLDING = threading.local()


class _Gate:
    """One owner's hand-off between its mutations and its snapshots: ``waiters``
    snapshots asked, ``holders`` of them copy now, ``updaters`` mutations wait, and
    ``turn`` gives a waiting mutation the next go once a snapshot has copied."""

    def __init__(self) -> None:
        self.waiters = self.holders = self.updaters = 0
        self.turn = False


def begin_mutation(owner: Any) -> None:
    """Enter a state mutation of ``owner`` (a metric or a collection)."""
    owner._mutation_depth += 1
    # the depth is raised before the gate is read, and a snapshot raises the waiters
    # before it reads the depth: one of the two always sees the other
    gate = owner._gate
    if gate is not None and gate.waiters and owner._mutation_depth == 1 and id(owner) not in getattr(_HOLDING, "ids", ()):
        with _QUIESCE:
            owner._mutation_depth = 0
            gate.updaters += 1
            _QUIESCE.notify_all()
            _QUIESCE.wait_for(lambda: not gate.holders and (not gate.waiters or gate.turn), _YIELD_TIMEOUT_S)
            gate.updaters -= 1
            gate.turn = False
            owner._mutation_depth = 1


def end_mutation(owner: Any) -> None:
    """Leave a state mutation of ``owner``; wake a snapshot that waits for it."""
    owner._mutation_depth -= 1
    gate = owner._gate
    if not owner._mutation_depth and gate is not None and gate.waiters:
        with _QUIESCE:
            _QUIESCE.notify_all()


@contextmanager
def quiesced(owner: Any, timeout: float) -> Generator:
    """Hold off ``owner``'s mutations for the body; yields whether no mutation was in
    flight within ``timeout`` seconds (one in flight on this very thread never ends).
    A mutation that waited meanwhile goes before the next snapshot."""
    with _QUIESCE:
        if owner._gate is None:
            owner._gate = _Gate()
        gate = owner._gate
        gate.waiters += 1
        quiet = _QUIESCE.wait_for(lambda: not owner._mutation_depth and not gate.turn, timeout)
        if quiet:
            gate.holders += 1
    held = _HOLDING.__dict__.setdefault("ids", set())
    held.add(id(owner))
    try:
        yield quiet
    finally:
        held.discard(id(owner))
        with _QUIESCE:
            gate.waiters -= 1
            if quiet:
                gate.holders -= 1
                gate.turn = gate.updaters > 0
            if not (gate.waiters or gate.holders or gate.updaters or gate.turn):
                owner._gate = None
            _QUIESCE.notify_all()


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a metric's states live on; ``None`` means the card.

    Raises when the resolved device is a CUDA device and CUDA is absent, so a
    metric never runs on the CPU unless the caller asked for it.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this metric runs on the GPU by default. Pass `device='cpu'`"
            " to run it on the CPU."
        )
    return device


class Metric(torch.nn.Module):
    """Base class for all metrics.

    Standard flow::

        acc = MulticlassAccuracy(num_classes=5)
        for preds, target in loader:
            batch_acc = acc(preds, target)   # forward: batch value + accumulation
        total = acc.compute()                # epoch value, synced across processes

    Args:
        device: where states live and inputs are placed; ``None`` means ``"cuda"``.
        compute_on_cpu: move list states to the CPU after each update.
        dist_sync_on_step: sync state on every ``forward``.
        process_group: ``torch.distributed`` group to sync over.
        dist_sync_fn: custom ``(tensor, group) -> list[tensor]`` gather.
        distributed_available_fn: predicate for "is distributed".
        sync_on_compute: sync automatically inside ``compute``.
        compute_with_cache: cache the computed value until the next update or reset.
        compiled_update: ``None`` (follow the engine policy), ``True`` / ``False`` (force
            the compiled update engine on / off for this metric).
        scan_steps: ``None`` (follow ``TORCHMETRICS_TPU_SCAN`` / ``scan_context``), ``0`` /
            ``False`` (off) or K in [2, 1024]: queue K updates per graph replay.
        async_dispatch: ``None`` (follow ``TORCHMETRICS_TPU_ASYNC`` / ``async_context``),
            ``False`` / ``0`` (off), ``True`` or an in-flight bound in [1, 16]: drain the
            scan queue on a background worker.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    #: state names whose values must be identical on every rank: the divergence audit
    #: (``diag.audit_context`` / ``TORCHMETRICS_TPU_AUDIT=1``) fingerprints them in the
    #: packed sync's metadata exchange and flags cross-rank divergence
    _rank_invariant_states: frozenset = frozenset()
    _gate: Optional[_Gate] = None  # the hand-off with snapshots, while one is asked for (quiesced)
    # the CUDA stream of the last update or forward: a snapshot's copy is enqueued there
    _write_stream: Optional[torch.cuda.Stream] = None

    def __init__(self, device: Optional[Union[str, torch.device]] = None, **kwargs: Any) -> None:
        super().__init__()
        self._device = resolve_device(device)

        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        if not isinstance(self.compute_on_cpu, bool):
            raise ValueError(f"Expected keyword argument `compute_on_cpu` to be a `bool` but got {self.compute_on_cpu}")
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError(
                f"Expected keyword argument `dist_sync_on_step` to be a `bool` but got {self.dist_sync_on_step}"
            )
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError(
                f"Expected keyword argument `dist_sync_fn` to be an callable function but got {self.dist_sync_fn}"
            )
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError(
                f"Expected keyword argument `sync_on_compute` to be a `bool` but got {self.sync_on_compute}"
            )
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError(
                f"Expected keyword argument `compute_with_cache` to be a `bool` but got {self.compute_with_cache}"
            )
        # compiled update engine (engine/): None = follow the process-wide policy
        # (auto-on for a CUDA device), True/False forces it for this metric
        self.compiled_update = kwargs.pop("compiled_update", None)
        if self.compiled_update is not None and not isinstance(self.compiled_update, bool):
            raise ValueError(
                f"Expected keyword argument `compiled_update` to be a `bool` or `None` but got {self.compiled_update}"
            )
        # the scan queue (engine/scan.py): None = the process policy, 0/False = off for
        # this metric, an int K >= 2 = depth K; async drains (engine/async_dispatch.py)
        # layer on it: None = the policy, False/0 = off, True/int = on with that bound
        self.scan_steps = coerce_k(kwargs.pop("scan_steps", None))
        self.async_dispatch = coerce_inflight(kwargs.pop("async_dispatch", None))
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")

        self._dtype = torch.float32  # of Python float defaults; set_dtype changes it
        self._defaults: Dict[str, Union[List, torch.Tensor]] = {}
        self._state_specs: Dict[str, Any] = {}  # engine/statespec.py: one StateSpec per state
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}

        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._update_signature = inspect.signature(self.update)
        self._epoch = None  # engine/epoch.py EpochEngine, made at the first packed sync
        self._engine = None  # engine/compiled.py CompiledUpdate, made at the first engine step
        # True while every state is the one add_state or reset put there: set by
        # reset, cleared by any write to a registered state (__setattr__). States are
        # clones of their defaults, so an identity test cannot tell.
        self._state_fresh = True
        self._computed = None
        self._forward_cache = None
        self._update_count = 0
        self._forward_depth = 0  # > 0 inside forward: its updates bypass the scan queue
        # > 0 while forward, an update or a scan drain is changing the states: a
        # snapshot taken by a signal handler then (parallel/elastic.py) would be torn
        self._mutation_depth = 0
        self._in_batch_value = False  # forward's batch compute: no quarantine read
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._cache: Optional[Dict[str, Any]] = None
        self._is_synced = False
        # dist_reduce_fx=None tensor states that hold a stacked (shards, *default.shape)
        # layout, tracked so folding never has to guess from ndim
        self._none_folded: set = set()

    @property
    def update_called(self) -> bool:
        """Whether ``update`` / ``forward`` has been called since init or reset."""
        return self._update_count > 0

    @property
    def update_count(self) -> int:
        """Number of ``update`` / ``forward`` calls since init or reset."""
        return self._update_count

    @property
    def device(self) -> torch.device:
        """Device of the metric states."""
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        """Floating dtype of the states (``set_dtype`` changes it)."""
        return self._dtype

    def add_state(
        self,
        name: str,
        default: Union[list, torch.Tensor, float, int],
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
        spec: Optional[Any] = None,
    ) -> None:
        """Register a state: a tensor (any shape) or an empty list for "cat" states.

        ``dist_reduce_fx`` in {"sum", "mean", "cat", "max", "min", None, callable}
        selects how the state folds across processes and across ``forward`` steps.
        ``spec`` declares a packed-sync role the reduction alone cannot say, as the
        serving states do (``engine/statespec.validate_role_spec``): the heavy-hitter
        grid and its jointly folded ``(ids, counts)`` pair, the ring clock; or it is a
        ready ``StateSpec``. Under an active state mesh a tensor state whose shard rule
        resolves to a partition is born distributed (``parallel/sharding.place_state``):
        only this rank's block is copied to the device.
        """
        if isinstance(default, (int, float)):
            default = torch.tensor(default, dtype=self._dtype if isinstance(default, float) else torch.int32)
        if not (isinstance(default, torch.Tensor) or (isinstance(default, list) and not default)):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if isinstance(dist_reduce_fx, str):
            if dist_reduce_fx not in _REDUCTIONS:
                raise ValueError(
                    "`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]"
                )
            dist_reduce_fx = _REDUCTIONS[dist_reduce_fx]
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")

        overrides = validate_role_spec(name, spec) if isinstance(spec, dict) else spec
        spec_obj = register_state_spec(self, build_spec(self, name, dist_reduce_fx, overrides))
        if isinstance(default, torch.Tensor):
            placed = default
            if spec_obj.shard_rule != "replicate" or (
                _sharding.partition_rules_active() and _sharding.match_partition_rule(name, type(self).__name__)
            ):
                # born distributed: the default itself is placed, so reset keeps it
                placed = _sharding.place_state(self, name, default, spec_obj)
            default = default.to(self._device) if placed is default else placed
            setattr(self, name, default.clone())
        else:
            setattr(self, name, [])
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx

    def _apply_shard_rules(self) -> None:
        """Re-place rule-carrying states after a host round-trip (``load_state_dict``,
        unpickling, ``restore_resharded``); a no-op without such a rule or a mesh."""
        specs = self.__dict__.get("_state_specs") or {}
        if any(sp.shard_rule != "replicate" for sp in specs.values()) or _sharding.partition_rules_active():
            _sharding.reshard_states(self)

    def state_specs(self) -> Dict[str, Any]:
        """Every registered state's ``StateSpec`` (``engine/statespec.py``), in
        registration order."""
        return specs_of(self, consumer="state_specs")

    # ------------------------------------------------------------------ forward

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch into the global state AND return the batch value."""
        with _diag.call("api.forward", type(self).__name__, child=False):
            return self._forward(args, kwargs)

    def _forward(self, args: tuple, kwargs: Dict[str, Any]) -> Any:
        if self._is_synced:
            raise TorchMetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. HINT: Did you forget to call ``unsync``?"
            )
        # forward returns a value: queued steps fold in first, and forward's own
        # updates bypass the queue
        self._drain_scan("observation:forward")
        self._forward_depth += 1
        # forward folds its batch state outside the update wrapper: the whole call
        # is one mutation
        begin_mutation(self)
        try:
            # quarantine takes the full-state path: its global update gets the
            # device select, where the reduce path's count-weighted mean fold would
            # dilute the state by every quarantined batch
            if self.full_state_update or self.full_state_update is None or self.dist_sync_on_step or txn.quarantine_enabled():
                self._forward_cache = self._forward_full_state_update(*args, **kwargs)
            else:
                self._forward_cache = self._forward_reduce_state_update(*args, **kwargs)
        finally:
            self._end_write()
            self._forward_depth -= 1
        return self._forward_cache

    @contextmanager
    def _batch_value_context(self) -> Generator:
        """Sync only on ``dist_sync_on_step``, never unsync mid-forward, keep list states
        of the throwaway batch state on the device; restore every flag after."""
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        _temp_compute_on_cpu = self.compute_on_cpu
        self.compute_on_cpu = False
        self._in_batch_value = True
        try:
            yield
        finally:
            self._in_batch_value = False
            self._is_synced = False
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
            self.compute_on_cpu = _temp_compute_on_cpu

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Two-``update`` forward: global update, then a batch-only update and compute."""
        self.update(*args, **kwargs)
        _update_count = self._update_count
        with self._batch_value_context():
            cache = self._copy_state_refs()
            self.reset()
            self.update(*args, **kwargs)
            batch_val = self.compute()
            self._restore_state_refs(cache)
            self._update_count = _update_count
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """One-``update`` forward: batch update and compute on reset state, then fold."""
        global_state = self._copy_state_refs()
        _update_count = self._update_count
        self.reset()
        with self._batch_value_context():
            self.update(*args, **kwargs)
            batch_val = self.compute()
            self._update_count = _update_count + 1
            self._reduce_states(global_state)
        return batch_val

    def _copy_state_refs(self) -> Dict[str, Any]:
        # the eager path replaces states and never writes them in place, so references
        # are a snapshot; an engine's static buffer is written in place by the next
        # replay, so it is copied
        def owned(v: Any) -> Any:
            return v.clone() if is_static(v) else v

        refs: Dict[str, Any] = {
            attr: (list(v) if isinstance(v := getattr(self, attr), list) else owned(v)) for attr in self._defaults
        }
        refs["__none_folded__"] = frozenset(self._none_folded)
        # the riders ride sync and forward snapshots like states: a packed sync folds
        # them across ranks, so unsync must restore the local ones
        if txn.ATTR in self.__dict__:
            refs[txn.ATTR] = owned(self.__dict__[txn.ATTR])
            refs["_quarantine_reported"] = self.__dict__.get("_quarantine_reported", 0)
        if numerics.ATTR in self.__dict__:
            refs[numerics.ATTR] = {k: owned(v) for k, v in self.__dict__[numerics.ATTR].items()}
        return refs

    def _restore_state_refs(self, cache: Dict[str, Any]) -> None:
        # a reported-watermark change inside the window means a quarantine read
        # surfaced the world total: the restored local count is already reported
        read_in_window = (
            "_quarantine_reported" in cache
            and self.__dict__.get("_quarantine_reported", 0) != cache["_quarantine_reported"]
        )
        for attr, val in cache.items():
            if attr == "__none_folded__":
                self._none_folded = set(val)
            elif attr in (txn.ATTR, "_quarantine_reported", numerics.ATTR):
                self.__dict__[attr] = val
            else:
                setattr(self, attr, val)
        if read_in_window:
            txn.mark_reported(self)

    def _fold(
        self,
        attr: str,
        first: Any,
        second: Any,
        first_count: int,
        second_count: int,
        first_folded: Optional[bool],
        second_folded: Optional[bool],
    ) -> Any:
        """Fold two values of one state by its reduction (``first`` is the older side)."""
        reduce_fn = self._reductions[attr]
        if reduce_fn is dim_zero_sum:
            return first + second
        if reduce_fn is dim_zero_mean:
            total = max(first_count + second_count, 1)
            return (first_count * first + second_count * second) / total
        if reduce_fn is dim_zero_max:
            return torch.maximum(first, second)
        if reduce_fn is dim_zero_min:
            return torch.minimum(first, second)
        if reduce_fn is dim_zero_cat:
            return (list(first) if isinstance(first, list) else [first]) + (
                list(second) if isinstance(second, list) else [second]
            )
        if reduce_fn is None and isinstance(first, torch.Tensor):
            return self._fold_none_tensors(attr, first, second, first_folded, second_folded)
        if reduce_fn is None and isinstance(first, list):
            return _flatten([first, second])
        if callable(reduce_fn):
            return reduce_fn(torch.stack([first, second]))
        raise TypeError(f"Unsupported reduce_fn: {reduce_fn}")

    def merge_state(self, incoming_state: Union["Metric", Dict[str, Any]], incoming_count: int = 1) -> None:
        """Fold another metric's state (or a raw state dict) into this one.

        Mean states are weighted by update counts (taken from the incoming metric, or
        ``incoming_count`` for raw dicts).
        """
        # both sides of the fold are observed: their queued steps fold in first
        self._drain_scan("observation:merge_state")
        incoming_folded: Optional[frozenset] = None  # raw dicts: unknown -> ndim fallback
        if isinstance(incoming_state, Metric):
            incoming_state._drain_scan("observation:merge_state")
            incoming_count = numerics.py_count(incoming_state._update_count)
            incoming_folded = frozenset(incoming_state._none_folded)
            source = incoming_state.__dict__
            incoming_state = {attr: getattr(incoming_state, attr) for attr in incoming_state._defaults}
        else:
            source = incoming_state
        incoming_quarantined = source.get(txn.ATTR)
        incoming_q_reported = source.get("_quarantine_reported", 0)
        incoming_res = dict(source.get(numerics.ATTR) or {})
        self_count = numerics.py_count(self._update_count)
        incoming_count = numerics.py_count(incoming_count)
        self_res = self.__dict__.get(numerics.ATTR) or {}
        merged_res: Dict[str, Any] = dict(self_res)
        for attr in self._defaults:
            first, second = getattr(self, attr), incoming_state[attr]
            reduce_fn = self._reductions[attr]
            if (attr in self_res or attr in incoming_res) and reduce_fn in (dim_zero_sum, dim_zero_mean):
                zeros = torch.zeros_like(first)
                r1, r2 = self_res.get(attr, zeros), incoming_res.get(attr, zeros)
                if reduce_fn is dim_zero_sum:
                    # compensated shards fold by two-sum: the residuals add, and the
                    # values' exact fold error joins them
                    reduced, err = numerics.two_sum(first, second)
                    merged_res[attr] = r1 + r2 + err
                else:
                    # a mean-reduced residual folds with the values' count weighting
                    total = max(self_count + incoming_count, 1)
                    reduced = (self_count * first + incoming_count * second) / total
                    merged_res[attr] = (self_count * r1 + incoming_count * r2) / total
                setattr(self, attr, reduced)
                continue
            setattr(
                self,
                attr,
                self._fold(
                    attr,
                    first,
                    second,
                    self_count,
                    incoming_count,
                    attr in self._none_folded,
                    None if incoming_folded is None else attr in incoming_folded,
                ),
            )
        self._update_count = self_count + incoming_count
        if self_res or incoming_res:
            self.__dict__[numerics.ATTR] = merged_res
        if incoming_quarantined is not None:
            # additive in the counter and in the reported watermark
            self.__dict__[txn.ATTR] = txn.ensure_count(self) + incoming_quarantined
            self.__dict__["_quarantine_reported"] = self.__dict__.get("_quarantine_reported", 0) + incoming_q_reported
        self._computed = None

    def _fold_none_tensors(
        self, attr: str, first: Any, second: Any, first_folded: Optional[bool], second_folded: Optional[bool]
    ) -> torch.Tensor:
        """N-way fold of a ``dist_reduce_fx=None`` tensor state: append shard rows."""
        base_ndim = self._defaults[attr].ndim

        def _rows(x: Any, folded: Optional[bool]) -> torch.Tensor:
            x = torch.as_tensor(x, device=self._device)
            if folded is None:  # unknown provenance: infer from rank
                folded = x.ndim == base_ndim + 1
            return x if folded else x[None]

        out = torch.cat([_rows(first, first_folded), _rows(second, second_folded)], dim=0)
        self._none_folded.add(attr)
        return out

    def _reduce_states(self, incoming_state: Dict[str, Any]) -> None:
        """Fold the snapshotted global state (``incoming_state``) with the batch state."""
        if self.__dict__.get(_sharding.LAYOUT_ATTR):
            # a sharded metric folds its local blocks (forward's snapshot holds DTensors)
            incoming_state = {k: _sharding.local(v) for k, v in incoming_state.items()}
            with _sharding.local_states(self):
                self._reduce_local_states(incoming_state)
            return
        self._reduce_local_states(incoming_state)

    def _reduce_local_states(self, incoming_state: Dict[str, Any]) -> None:
        global_folded = incoming_state.get("__none_folded__")
        global_res = incoming_state.get(numerics.ATTR) or {}
        local_res = self.__dict__.get(numerics.ATTR) or {}
        merged_res: Dict[str, Any] = dict(local_res)
        for attr in self._defaults:
            global_state, local_state = incoming_state[attr], getattr(self, attr)
            reduce_fn = self._reductions[attr]
            if (attr in global_res or attr in local_res) and reduce_fn in (dim_zero_sum, dim_zero_mean):
                zeros = torch.zeros_like(global_state)
                g_res, l_res = global_res.get(attr, zeros), local_res.get(attr, zeros)
                if reduce_fn is dim_zero_sum:
                    # the global (value, residual) absorbs the batch through the same
                    # two-sum the compiled step uses
                    reduced, merged_res[attr] = numerics.two_sum(global_state, local_state + g_res + l_res)
                else:
                    count = self._update_count
                    reduced = ((count - 1) * global_state + local_state) / count
                    merged_res[attr] = ((count - 1) * g_res + l_res) / count
                setattr(self, attr, reduced)
                continue
            setattr(
                self,
                attr,
                self._fold(
                    attr,
                    global_state,
                    local_state,
                    self._update_count - 1,
                    1,
                    None if global_folded is None else attr in global_folded,
                    attr in self._none_folded,
                ),
            )
        if global_res or local_res:
            self.__dict__[numerics.ATTR] = merged_res
        # the reset before the batch update zeroed the counter: fold the global back
        global_quarantined = incoming_state.get(txn.ATTR)
        local_quarantined = self.__dict__.get(txn.ATTR)
        if global_quarantined is not None and local_quarantined is not None:
            self.__dict__[txn.ATTR] = global_quarantined + local_quarantined
            self.__dict__["_quarantine_reported"] = incoming_state.get("_quarantine_reported", 0)

    # ------------------------------------------------------------------ sync

    def _sync_dist(self, dist_sync_fn: Callable = gather_all_tensors, process_group: Optional[Any] = None) -> None:
        """Gather every state from all processes and apply its reduction.

        A live-sharded state is skipped (global by construction on a 1-D mesh); on a
        ``(data, state)`` mesh it is folded over this rank's ``data`` sub-group, which
        the replicated states then gather over (``parallel/sharding.sync_scope``).
        """
        sharded = [a for a in self._reductions if _sharding.is_sharded(self.__dict__.get(a))]
        group = process_group or self.process_group
        if group is None and _sharding.metric_state_mesh(self) is not None:
            data_size, group = _sharding.sync_scope([self])
            if data_size == 1:
                return  # one data row: the replicated states are whole, the sharded global
            for attr in sharded:
                fold = state_fold(self, attr)[0]
                setattr(self, attr, _sharding.fold_over_data(getattr(self, attr), fold, group, data_size))
        input_dict = {attr: getattr(self, attr) for attr in self._reductions if attr not in sharded}
        for attr, reduction_fn in self._reductions.items():
            # pre-concatenate list states to one collective each
            if reduction_fn is dim_zero_cat and isinstance(input_dict[attr], list) and len(input_dict[attr]) > 1:
                input_dict[attr] = [dim_zero_cat(input_dict[attr])]

        group = process_group or self.process_group
        if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
            self._check_list_states(input_dict, group)

        output_dict = apply_to_collection(input_dict, torch.Tensor, dist_sync_fn, group=group)

        for attr, reduction_fn in self._reductions.items():
            if attr not in output_dict:
                continue
            if isinstance(output_dict[attr], list) and len(output_dict[attr]) == 0:
                setattr(self, attr, [])
                continue
            if isinstance(output_dict[attr][0], torch.Tensor):
                output_dict[attr] = torch.stack(output_dict[attr])
                if reduction_fn is None:
                    # gathered None-reduced tensors now carry a leading shard axis
                    self._none_folded.add(attr)
            elif isinstance(output_dict[attr][0], list):
                output_dict[attr] = _flatten(output_dict[attr])
            reduced = reduction_fn(output_dict[attr]) if reduction_fn is not None else output_dict[attr]
            setattr(self, attr, reduced)

    def _check_list_states(self, input_dict: Dict[str, Any], group: Optional[Any]) -> None:
        """Raise on every rank before a list state's collectives could deadlock.

        A list state syncs one collective per element, so ranks holding different
        list lengths would enter different numbers of collectives. ``cat`` lists are
        pre-concatenated (0 or 1 element), so only mixed emptiness can diverge;
        ``None``-reduced lists keep their elements positional, so any count mismatch,
        or equal counts with other per-element shapes, is fatal. One fixed-shape int32
        ``all_gather`` of ``[count, shape fingerprint]`` per list state covers them
        all. The list states are chosen by their defaults' type, identical on every
        rank, so the probe itself is never ragged.
        """
        list_attrs = [
            attr
            for attr, fn in self._reductions.items()
            if (fn is dim_zero_cat or fn is None) and isinstance(self._defaults[attr], list)
        ]
        if not list_attrs:
            return

        def _fingerprint(x: Any) -> int:
            dims: List[int] = []
            for el in x if isinstance(x, list) else [x]:
                shape = tuple(getattr(el, "shape", ()))  # a raw string counts as 0-d
                dims.append(len(shape))
                dims.extend(int(d) for d in shape)
            return shape_fingerprint(dims)

        values = [input_dict[a] for a in list_attrs]
        local = torch.tensor(
            [[len(x) if isinstance(x, list) else 1, _fingerprint(x)] for x in values],
            dtype=torch.int32,
            device=self._device,
        )
        gathered = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(gathered, local, group=group)
        probe = torch.stack(gathered).cpu().numpy()
        for idx, attr in enumerate(list_attrs):
            counts, prints = probe[:, idx, 0], probe[:, idx, 1]
            is_cat = self._reductions[attr] is dim_zero_cat
            if (counts.max() > 0 and counts.min() == 0) if is_cat else (counts.max() != counts.min()):
                raise TorchMetricsUserError(
                    f"Cannot sync list state `{attr}`: processes hold differing element counts"
                    f" {counts.tolist()} — ranks with fewer elements would skip collectives the rest"
                    " enter and deadlock the world. Ensure every process sees the same number of"
                    " updates before compute(), or skip syncing (sync_on_compute=False) for ragged epochs."
                )
            if not is_cat and prints.max() != prints.min():
                raise TorchMetricsUserError(
                    f"Cannot sync list state `{attr}`: processes hold equal element counts but mismatched"
                    f" per-element shapes (shape fingerprints {prints.tolist()}). Positional collectives"
                    " over a None-reduced list state require identical per-position shapes on every rank"
                    " — e.g. differing final packed-batch sizes must be padded to a common shape before"
                    " update, or skip syncing (sync_on_compute=False)."
                )

    def _epoch_engine(self) -> Any:
        """The metric's packed-sync engine (``engine/epoch.py``), made at first use."""
        if self._epoch is None:
            from torchmetrics_tpu_torch.engine.epoch import EpochEngine

            self._epoch = EpochEngine(self)
        return self._epoch

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Sync the states across processes; ``unsync`` restores the local ones."""
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        # the exchanged buffers must hold every queued step
        self._drain_scan("observation:sync")
        if distributed_available is None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else None
        if not should_sync or not is_distributed:
            return
        if dist_sync_fn is None:
            # packed route: one metadata gather (when needed) plus one collective per
            # (role, dtype) buffer for all states; what it cannot take syncs eagerly
            if self.compute_on_cpu:
                self._epoch_engine().stats.fallback("sync:compute-on-cpu")
            elif (process_group or self.process_group) is not None:
                self._epoch_engine().stats.fallback("sync:sub-world-process-group")
            else:
                snapshot = self._copy_state_refs()
                if self._epoch_engine().packed_sync():
                    self._cache = snapshot
                    self._is_synced = True
                    return
            dist_sync_fn = gather_all_tensors
        else:
            self._epoch_engine().stats.fallback("sync:custom-dist-sync-fn")
        _diag.record("sync.eager", type(self).__name__)
        self._cache = self._copy_state_refs()
        self._sync_dist(dist_sync_fn, process_group=process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the pre-sync local state."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._restore_state_refs(self._cache)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator:
        """``sync`` on entry, ``unsync`` on exit (also when the body raises)."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        try:
            yield
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------------------ wrapping

    def _place(self, x: Any) -> Any:
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(x, device=self._device)
        return x

    def _wrap_update(self, update: Callable) -> Callable:
        self._raw_update = update  # the unwrapped body: what the engine runs as a graph

        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            with _diag.call("api.update", type(self).__name__, child=False):
                args = tuple(self._place(a) for a in args)
                kwargs = {k: self._place(v) for k, v in kwargs.items()}
                if txn.quarantine_mode() == txn.MODE_ERROR and not self.__dict__.pop("_admission_prechecked", False):
                    # raises before any mutation (unless the collection step admitted
                    # this very batch already: one host read per step, not two)
                    txn.admission_check_or_raise(self, args, kwargs)
                # the count bump, the step (a graph replay or the eager body) and the
                # list moves are one mutation for a signal-time snapshot
                begin_mutation(self)
                try:
                    self._computed = None
                    self._update_count += 1
                    if not self._engine_step(args, kwargs):
                        owner = type(self).__name__
                        with _diag.span("eager.update", owner) as sp:
                            if sp is not None:
                                eng = self._engine
                                sp.attrs = {"reason": eng.stats.last_fallback if eng is not None else "engine-off"}
                            self._run_eager_update(args, kwargs)
                        # eager steps sit in the same timeline and histograms as replays
                        _diag.observe_dispatch(sp, owner, "eager", "update.eager")
                    if self.compute_on_cpu:
                        self._move_list_states_to_cpu()
                finally:
                    self._end_write()

        return wrapped_func

    def _end_write(self) -> None:
        """Leave an update's or forward's mutation. The outermost records the stream
        that wrote: the engine replays, and an eager body runs, on the caller's stream."""
        if self._mutation_depth == 1 and self._device.type == "cuda":
            self._write_stream = torch.cuda.current_stream(self._device)
        end_mutation(self)

    def _run_eager_update(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        """One eager update with the riders of the compiled step (the compensated
        two-sum, the quarantine transaction): the update wrapper's fallback and the scan
        queue's one-step replay. The bookkeeping (``_update_count``) is the caller's."""
        if self.__dict__.get(_sharding.LAYOUT_ATTR):
            with _sharding.local_states(self):
                self._run_local_update(args, kwargs)
            return
        self._run_local_update(args, kwargs)

    def _run_local_update(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        update = self._raw_update
        if numerics.compensation_active(self):

            def body() -> None:
                numerics.eager_update(self, lambda: update(*args, **kwargs))

        else:

            def body() -> None:
                update(*args, **kwargs)

        if txn.quarantine_mode() == txn.MODE_QUARANTINE:
            txn.eager_update(self, body, args, kwargs)
        else:
            body()

    def _engine_step(self, args: tuple, kwargs: Dict[str, Any]) -> bool:
        """Route one update through the compiled engine, queued when a scan depth is
        active (not inside ``forward``: it asks for a value); False = run it eagerly."""
        enabled = self._epoch_enabled()
        k = self._scan_depth() if enabled else None
        queueing = k is not None and not self._forward_depth
        eng = self._engine
        if not queueing and eng is not None and eng._scan is not None and eng._scan.pending:
            # a queue left over from a closed scan scope or a disabled engine drains
            # before this step applies, whatever path it takes
            eng._scan.drain("scan-disabled")
        if not enabled:
            return False
        if eng is None:
            eng = self._engine = CompiledUpdate(self)
        if queueing:
            # the async tier is resolved only where a scan queue is active
            return eng.scan_step(args, kwargs, k, resolve_async(self.async_dispatch))
        return eng.step(args, kwargs)

    def _scan_depth(self) -> Optional[int]:
        """The active scan queue depth for this metric, or None (unqueued)."""
        if self.scan_steps is not None:
            return self.scan_steps or None  # 0 = forced off for this metric
        return scan_k()

    def _drain_scan(self, reason: str) -> int:
        """Drain any scan queue holding this metric's pending steps. Every state
        observation comes here first; a compute-group view also drains its owner's
        queue (``_scan_peer``, stamped when the views are materialized)."""
        begin_mutation(self)  # a drain binds and replays the queued steps' states
        try:
            drained = flush_metric(self, reason)
            peer_ref = self.__dict__.get("_scan_peer")
            peer = peer_ref() if peer_ref is not None else None
            if peer is not None:
                drained += flush_metric(peer, reason)
        finally:
            end_mutation(self)
        return drained

    def _epoch_enabled(self) -> bool:
        """Engine enablement for this metric: ``compiled_update`` > overrides > auto."""
        if self.compiled_update is None:
            return engine_enabled(self._device)
        return self.compiled_update

    def _move_list_states_to_cpu(self) -> None:
        for key in self._defaults:
            current_val = getattr(self, key)
            if isinstance(current_val, list):
                setattr(self, key, [v.to("cpu") if isinstance(v, torch.Tensor) else v for v in current_val])

    def _wrap_compute(self, compute: Callable) -> Callable:
        self._raw_compute = compute  # the unwrapped body: what the epoch engine captures

        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            with _diag.call("api.compute", type(self).__name__, child=False):
                # compute observes the states: queued steps fold in first
                self._drain_scan("observation:compute")
                if self._update_count == 0:
                    rank_zero_warn(
                        f"The ``compute`` method of metric {self.__class__.__name__} was called before the ``update``"
                        " method which may lead to errors, as metric states have not yet been updated.",
                        UserWarning,
                    )
                elif not self._in_batch_value and txn.quarantine_enabled() and self.__dict__.get(txn.ATTR) is not None:
                    # compute is the epoch boundary where the counter is read; a state
                    # that every batch was quarantined from is its default
                    if txn.read_quarantine(self)["count"] >= self._update_count:
                        rank_zero_warn(
                            f"Every batch seen by metric {self.__class__.__name__} failed quarantine"
                            " admission — ``compute`` is folding default (empty) state. Inspect"
                            " the input pipeline or run with TORCHMETRICS_TPU_QUARANTINE=error.",
                            UserWarning,
                        )
                if self._computed is not None:
                    return self._computed
                if self.__dict__.get(numerics.ATTR):
                    # the epoch-boundary fold of each compensated (value, residual) pair
                    with _sharding.local_states(self):
                        numerics.reanchor(self)
                fused = self._epoch_sync_for_compute() if not args and not kwargs else None
                if fused is not None:
                    from torchmetrics_tpu_torch.engine.epoch import NO_VALUE

                    try:
                        value = fused[0]
                        if value is NO_VALUE:  # the sync was packed; compute runs on the synced states
                            value = self._engine_compute(compute, args, kwargs)
                        value = detach_from_static(_squeeze_if_scalar(value), [getattr(self, a) for a in self._defaults])
                    finally:
                        if self._is_synced and self._should_unsync:
                            self.unsync()
                else:
                    with self.sync_context(
                        dist_sync_fn=self.dist_sync_fn,
                        should_sync=self._to_sync,
                        should_unsync=self._should_unsync,
                    ):
                        with _sharding.full_view(self):
                            value = _squeeze_if_scalar(self._engine_compute(compute, args, kwargs))
                        # a value handed out never shares storage with a buffer the next
                        # engine replay writes in place
                        value = detach_from_static(value, [getattr(self, a) for a in self._defaults])
                if self.compute_with_cache:
                    self._computed = value
                return value

        return wrapped_func

    def _engine_compute(self, compute: Callable, args: tuple, kwargs: Dict[str, Any]) -> Any:
        """``compute`` through its cached graph when the engine is on and it is eligible
        (``engine/epoch.py``), else the body itself."""
        with _diag.span("epoch.compute", type(self).__name__) as sp:
            graph = False
            if not args and not kwargs and self._epoch_enabled():
                graph, value = self._epoch_engine().cached_compute()
            if not graph:
                value = compute(*args, **kwargs)
            if sp is not None:
                sp.attrs = {"graph": graph}
            return value

    def _epoch_sync_for_compute(self) -> Optional[tuple]:
        """The fused route of a ``compute`` across processes: the packed exchange, then
        one graph for the fold and the compute. None when it does not apply (the
        caller takes ``sync_context``, whose ``sync`` may still be packed); else a
        1-tuple of the value, ``engine.epoch.NO_VALUE`` when only the sync was fused."""
        if self._is_synced or not self._to_sync or self.dist_sync_fn is not None or self.compute_on_cpu:
            return None
        if _sharding.holds_sharded(self):
            return None  # the compute runs on the assembled states (full_view)
        if self.process_group is not None or not self._epoch_enabled():
            return None
        available = self.distributed_available_fn
        if not (callable(available) and available()):
            return None
        snapshot = self._copy_state_refs()
        res = self._epoch_engine().sync_and_compute()
        if res is None:
            return None
        self._cache = snapshot
        self._is_synced = True
        return res

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs that ``update`` accepts (all of them if it takes ``**kwargs``)."""
        params = self._update_signature.parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        positional = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        return {k: v for k, v in kwargs.items() if k in params and params[k].kind not in positional}

    def update(self, *_: Any, **__: Any) -> None:
        """Override to update state from a batch."""
        raise NotImplementedError

    def compute(self) -> Any:
        """Override to compute the final value from state."""
        raise NotImplementedError

    # ------------------------------------------------------------------ plot

    def plot(self, *_: Any, **__: Any) -> Any:
        """Override to plot the metric value."""
        raise NotImplementedError

    def _plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot one value or a sequence of values (``utilities/plot.py``)."""
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val,
            ax=ax,
            higher_is_better=self.higher_is_better,
            name=self.__class__.__name__,
            lower_bound=self.plot_lower_bound,
            upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
        )

    # ------------------------------------------------------------------ lifecycle

    def reset(self) -> None:
        """Reset all states to their defaults; queued steps are discarded (applying what
        the reset wipes is the same as skipping it), the riders restart at zero."""
        discard_metric(self, "reset")
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for attr, default in self._defaults.items():
            setattr(self, attr, default.clone() if isinstance(default, torch.Tensor) else [])
        self._cache = None
        self._is_synced = False
        self._none_folded = set()
        self._state_fresh = True
        if self.__dict__.get(txn.ATTR) is not None:
            self.__dict__[txn.ATTR] = torch.zeros_like(self.__dict__[txn.ATTR])
            self.__dict__["_quarantine_reported"] = 0
        if self.__dict__.get(numerics.ATTR):
            self.__dict__[numerics.ATTR] = {k: torch.zeros_like(v) for k, v in self.__dict__[numerics.ATTR].items()}
        flags = self.__dict__.get(_sentinel.ATTR)
        if flags is not None:
            # sticky across updates and syncs, restarted by a reset: in place, since the
            # bitmask may be an engine's static buffer that later replays read
            flags.zero_()

    def state_footprint(self) -> Dict[str, Any]:
        """Bytes held by this metric's states, riders and engine buffers (``diag/costs.py``)."""
        self._drain_scan("observation:state_footprint")
        from torchmetrics_tpu_torch.diag.costs import state_footprint

        return state_footprint(self)

    def snapshot_compute(self) -> Any:
        """Scrape-anytime ``compute`` on a copy of the state (``serve/snapshot.py``).

        The live metric keeps updating while the value computes on a copy taken at a
        consistent watermark; its caches, sync status and counters are untouched.
        Rank-local: cross-rank totals belong to the epoch sync.
        """
        from torchmetrics_tpu_torch.serve.snapshot import snapshot_compute

        return snapshot_compute(self)

    def clone(self) -> "Metric":
        """Deep copy of the metric."""
        return deepcopy(self)

    def __getstate__(self) -> Dict[str, Any]:
        """Drop the wrapped bound methods and the engines (graphs and buffers belong to
        the instance) for pickling, ``clone`` and ``deepcopy``; ``__setstate__`` re-wraps.
        Queued steps fold in first: the copy must not lag the stream."""
        self._drain_scan("observation:clone")
        drop = ("update", "compute", "_raw_update", "_raw_compute", "_scan_peer", "_txn_stats", "_gate",
                "_write_stream")
        state = {k: v for k, v in self.__dict__.items() if k not in drop}
        state["_epoch"] = None
        state["_engine"] = None
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        state.setdefault("compiled_update", None)
        state.setdefault("scan_steps", None)
        state.setdefault("async_dispatch", None)
        state.setdefault("_forward_depth", 0)
        state.setdefault("_mutation_depth", 0)
        state.setdefault("_in_batch_value", False)
        state.setdefault("_engine", None)
        state.setdefault("_state_specs", {})
        super().__setstate__(state)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        # a pickle made without a mesh re-places onto the active one (no-op otherwise)
        self._apply_shard_rules()

    def __setattr__(self, name: str, value: Any) -> None:
        """Write-protect class-constant metadata; a write to a registered state clears
        the freshness marker."""
        if name in (
            "higher_is_better",
            "is_differentiable",
            "full_state_update",
            "plot_lower_bound",
            "plot_upper_bound",
            "plot_legend_name",
        ):
            raise RuntimeError(f"Can't change const `{name}`.")
        if name in self.__dict__.get("_defaults", ()):
            self.__dict__["_state_fresh"] = False
        super().__setattr__(name, value)

    def to(self, device: Union[str, torch.device]) -> "Metric":  # type: ignore[override]
        """Move every state (and its default, and the riders) to ``device``."""
        self._drain_scan("observation:device-move")
        self._device = resolve_device(device)
        fresh = self._state_fresh  # a move keeps the values
        self._map_states(lambda x: x.to(self._device) if isinstance(x, torch.Tensor) else x, include_defaults=True)
        self._state_fresh = fresh
        return self

    def cpu(self) -> "Metric":  # type: ignore[override]
        return self.to("cpu")

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the floating states (their residuals with them) and their defaults to
        ``dst_type``."""
        self._drain_scan("observation:set_dtype")
        self._dtype = dst_type

        def _cast(x: Any) -> Any:
            return x.to(dst_type) if isinstance(x, torch.Tensor) and x.is_floating_point() else x

        fresh = self._state_fresh  # a cast keeps the values
        self._map_states(_cast, include_defaults=True)
        self._state_fresh = fresh
        return self

    def float(self) -> "Metric":  # type: ignore[override]
        """No-op: use ``set_dtype``."""
        return self

    def double(self) -> "Metric":  # type: ignore[override]
        """No-op: use ``set_dtype``."""
        return self

    def half(self) -> "Metric":  # type: ignore[override]
        """No-op: use ``set_dtype``."""
        return self

    def type(self, dst_type: Any) -> "Metric":  # type: ignore[override]
        """No-op: use ``set_dtype``."""
        return self

    def _map_states(self, fn: Callable, include_defaults: bool = False) -> None:
        """Apply ``fn`` to every state tensor (list elements too), the cached value and,
        with ``include_defaults``, the registered defaults."""
        for attr in self._defaults:
            val = getattr(self, attr)
            setattr(self, attr, [fn(v) for v in val] if isinstance(val, list) else fn(val))
            if include_defaults:
                d = self._defaults[attr]
                self._defaults[attr] = [fn(v) for v in d] if isinstance(d, list) else fn(d)
        if self._computed is not None:
            self._computed = apply_to_collection(self._computed, torch.Tensor, fn)
        if self.__dict__.get(txn.ATTR) is not None:
            self.__dict__[txn.ATTR] = fn(self.__dict__[txn.ATTR])
        if self.__dict__.get(numerics.ATTR):
            self.__dict__[numerics.ATTR] = {k: fn(v) for k, v in self.__dict__[numerics.ATTR].items()}
        if self.__dict__.get(_sentinel.ATTR) is not None:
            self.__dict__[_sentinel.ATTR] = fn(self.__dict__[_sentinel.ATTR])

    # ------------------------------------------------------------------ persistence

    def persistent(self, mode: bool = False) -> None:
        """Toggle persistence of all states."""
        for key in self._persistent:
            self._persistent[key] = mode

    _UPDATE_COUNT_KEY = "_update_count"

    def state_dict(  # type: ignore[override]
        self, destination: Optional[Dict] = None, prefix: str = "", keep_vars: bool = False
    ) -> Dict[str, Any]:
        """Persistent states (detached tensors) plus ``_update_count``, which keeps the
        weighting that ``merge_state`` and running means depend on. Queued steps fold in
        first; a compensated state is written anchored (``value + residual``), so a
        restore starts from the corrected total with a zero residual."""
        self._drain_scan("observation:state_dict")
        residuals = self.__dict__.get(numerics.ATTR) or {}
        destination = {} if destination is None else destination
        wrote_any = False
        for key in self._defaults:
            if not self._persistent[key]:
                continue
            current_val = getattr(self, key)
            if isinstance(current_val, torch.Tensor):
                block = _sharding.local(current_val)
                if key in residuals and residuals[key].shape == block.shape:
                    current_val = _sharding.wrap_like(self, key, numerics.anchored_value(block, residuals[key]))
                # a sharded state is written whole (one gather over its state group)
                destination[prefix + key] = _sharding.assemble(current_val).detach().clone()
            else:
                destination[prefix + key] = [v.detach().clone() if isinstance(v, torch.Tensor) else v for v in current_val]
            wrote_any = True
        if wrote_any:
            destination[prefix + self._UPDATE_COUNT_KEY] = self._update_count
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "") -> None:  # type: ignore[override]
        """Restore states saved by ``state_dict`` (or converted by ``interop.state_from_jax``);
        queued steps fold in first, and the residuals restart at zero (the saved values
        are anchored)."""
        self._drain_scan("observation:load_state_dict")
        restored_any = False
        for key in self._defaults:
            name = prefix + key
            if name not in state_dict:
                continue
            val = state_dict[name]
            if isinstance(val, list):
                setattr(self, key, [v if isinstance(v, str) else torch.as_tensor(v, device=self._device) for v in val])
            else:
                arr = torch.as_tensor(val, device=self._device)
                default = self._defaults[key]
                if isinstance(default, torch.Tensor) and default.is_floating_point() and arr.is_floating_point():
                    arr = arr.to(default.dtype)  # a float state keeps the dtype set_dtype gave it
                setattr(self, key, arr)
                # checkpoints carry no fold flags: recover a None-reduced state's
                # stacked-shard marker from its rank
                if self._reductions.get(key) is None and isinstance(self._defaults[key], torch.Tensor):
                    if arr.ndim == self._defaults[key].ndim + 1:
                        self._none_folded.add(key)
                    else:
                        self._none_folded.discard(key)
            restored_any = True
        count_key = prefix + self._UPDATE_COUNT_KEY
        if count_key in state_dict:
            self._update_count = int(state_dict[count_key])
        elif restored_any:
            self._update_count = max(self._update_count, 1)
        if restored_any:
            self._computed = None
            if self.__dict__.get(numerics.ATTR):
                self.__dict__[numerics.ATTR] = {k: torch.zeros_like(v) for k, v in self.__dict__[numerics.ATTR].items()}
            # a checkpoint holds whole states: rule-carrying ones re-place onto the mesh
            self._apply_shard_rules()

    def __hash__(self) -> int:
        """Hash of the class and the identities of the metric and its states."""
        hash_vals: list = [self.__class__.__name__, id(self)]
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # ------------------------------------------------------------------ operators

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.remainder, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # the JAX package's ``+m`` is ``abs``, and ``-m`` is ``-abs``: copied as they are
        return CompositionalMetric(torch.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    __invert__ = __inv__

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)

    def __getnewargs__(self) -> tuple:
        return tuple(self.__getstate__().get("_defaults", ()))

    __iter__ = None


def _neg(x: torch.Tensor) -> torch.Tensor:
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """Lazy arithmetic over metrics: ``op(metric_a, metric_b)`` on their values.

    Its device is its first operand metric's, so ``acc + 1`` on a CPU metric runs on
    the CPU; number and tensor operands move there. It holds no state: each operand
    metric updates, syncs and resets itself.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> total = SumMetric(device="cpu")
        >>> doubled = 2 * total
        >>> doubled.update(torch.tensor([1.0, 2.0]))
        >>> float(doubled.compute())
        6.0
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor, None],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        operand = metric_a if isinstance(metric_a, Metric) else metric_b
        super().__init__(device=operand.device if isinstance(operand, Metric) else None)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, x: Any) -> Any:
        if isinstance(x, (int, float, torch.Tensor, np.ndarray)):
            return torch.as_tensor(x, device=self._device)
        return x

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # the operand metrics sync themselves

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def __repr__(self) -> str:
        op_name = self.op.__name__ if hasattr(self.op, "__name__") else self.op
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"

    def _wrap_compute(self, compute: Callable) -> Callable:
        return compute
