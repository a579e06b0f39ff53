"""The K-step scan queue on CUDA graphs (counterpart of ``torchmetrics_tpu/engine/scan.py``).

An engine step still costs the Python around its replay. The scan queue amortizes
that over K steps: ``update`` copies the batch into the next slot of a ring of static
input slots and returns, and every K steps (or at the first state observation) one
drain replays ONE graph that runs the engine's own step body (``compiled.run_members``:
update, pad-subtract, compensated two-sum, quarantine transaction) once per queued
step against the static state buffers. Where the JAX package compiles ``lax.scan``
over the queued axis (``compile_scan``, ``masked_step``), the port captures one CUDA
graph per (signature, ring, ``kb``):

- **Slots.** A signature owns a ring of ``k_bucket(K)`` slots per input
  (``(slots, bucket, ...)`` static buffers that all of its graphs share), a static
  ``n_pad`` per slot and a static ``valid`` mask. Step ``t`` of a graph reads slot
  ``t``, ``n_pad[t]`` and ``valid[t]``, and writes ``where(valid[t], new, carry)`` into
  the state buffers, the rider keys included: a pad step's stale slot never moves a
  state, the quarantine counter or a residual.
- **K-buckets.** A drain of ``n <= K`` steps replays the ``kb = k_bucket(n)`` graph: a
  ragged tail reuses one of ``log2(K) + 1`` graphs per ring. Pad steps run, masked, and
  launch their kernels too (``kb`` times the step's launches per replay).
- **Enqueue copies.** ``push`` copies the batch into its slot on the caller's stream
  and zeroes the slot's pad tail: the JAX queue keeps references, which is safe for
  immutable arrays, but a torch tensor the caller reuses in place would be read stale
  by a later drain.
- **Drain.** ``valid`` is set by a device-to-device copy from a mask table made on the
  device (no tensor built from host values), then the graph replays. On the CPU
  nothing is captured: the drain runs the same masked body ``kb`` times on the same
  buffers.
- **Flush points.** Every state observation drains first (``Metric._drain_scan``,
  ``MetricCollection._drain_scan``; a compute-group view drains its owner's queue
  through ``_scan_peer``), and ``reset`` discards: applying updates a reset wipes is
  the same as skipping them. A drain that fails replays its steps one at a time from
  the slots, in order, counted, never lost.
- **Async.** With ``engine/async_dispatch.py`` on, a full buffer is swapped out under
  the queue lock and replayed by a background worker on a side stream while the caller
  fills the next ring (``async_inflight + 1`` rings per signature); each observation
  joins. A buffer's first drain of a (ring, ``kb``) pair captures on the caller's
  thread.

Enablement (invalid values raise): ``Metric(scan_steps=K)`` /
``MetricCollection(scan_steps=K)`` (``0``/``False`` forces off), then ``scan_context``
/ ``set_scan_steps``, then ``TORCHMETRICS_TPU_SCAN=K``. The queue rides the engine: it
is consulted only where the engine is on.

- **Diagnostics.** The sentinel rides each step of a scan graph with the other riders
  (``compiled.write_step``). A drain records ``update.scan`` (and, per new ``kb`` graph,
  ``update.scan.trace`` / ``retrace``; under a profile every Nth warm drain is an
  ``update.scan.probe``), a swap or discard ``scan.flush``, the async tier
  ``async.enqueue`` / ``async.drain`` / ``async.join`` with the ``enqueue_us`` and
  ``depth`` histograms; the lineage watermarks (``diag/lineage.py``) count enqueued,
  folded, replayed and discarded steps, and a swap's causal span rides its drain's
  events. Each ``kb`` graph lands in the cost ledger (kind ``scan``).

A sharded state's carry is its local block (``step_state``), and the placement joins the
queue's key, as in ``engine/compiled.py``.

With persistence on (``engine/persist.py``) each new ``kb`` graph is a counted lookup
miss, and its build appends a ``scan`` row: the per-step specs of its slots and ``k``.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import deque
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Deque, Dict, Generator, List, Optional, Sequence, Set, Tuple

import torch

from torchmetrics_tpu_torch import ops
from torchmetrics_tpu_torch.diag import costs as _costs
from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import profile as _profile
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine import bucketing
from torchmetrics_tpu_torch.engine import persist as _persist
from torchmetrics_tpu_torch.engine.compiled import (
    _FALLBACK,
    _BuildFailed,
    MemberPlan,
    annotation_scope,
    bind_buffers,
    completion_probe,
    copy_into_buffers,
    measured_capture,
    note_build,
    probe_events,
    run_members,
    shield_state,
    signature_fingerprint,
    state_signature,
    step_state,
    timed_replay,
)
from torchmetrics_tpu_torch.parallel import sharding as _sharding
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "MAX_K",
    "SCAN_ENV_VAR",
    "FusedScan",
    "MetricScan",
    "coerce_k",
    "discard_metric",
    "discard_metrics",
    "flush_all",
    "flush_metric",
    "flush_metrics",
    "k_bucket",
    "scan_context",
    "scan_k",
    "set_scan_steps",
]

SCAN_ENV_VAR = "TORCHMETRICS_TPU_SCAN"

#: upper bound on the queue depth: past ~1k steps the slots' device footprint (K x the
#: input bytes) dwarfs what is left to amortize
MAX_K = 1024

_UNSET = object()
_k_override: Any = _UNSET


# ------------------------------------------------------------------ policy


def coerce_k(value: Any) -> Optional[int]:
    """Validate a queue-depth knob: ``0``/``False`` = forced off, an int in [2, MAX_K] =
    depth; ``None`` passes through (defer to the policy)."""
    if value is None:
        return None
    if isinstance(value, bool):
        if value:
            raise TorchMetricsUserError(
                "scan_steps=True is ambiguous — pass the queue depth K (an int >= 2),"
                " or 0/False to disable the queue"
            )
        return 0
    if isinstance(value, int):
        if value == 0:
            return 0
        if 2 <= value <= MAX_K:
            return value
    raise TorchMetricsUserError(
        f"scan queue depth must be 0 (off) or an integer in [2, {MAX_K}] (got {value!r});"
        " K=1 is the unqueued engine — leave the knob unset instead"
    )


def scan_k() -> Optional[int]:
    """The active queue depth K, or ``None`` when the scan queue is off. An
    unrecognized ``TORCHMETRICS_TPU_SCAN`` value raises."""
    if _k_override is not _UNSET:
        return _k_override or None
    raw = os.environ.get(SCAN_ENV_VAR, "").strip().lower()
    if raw in ("", "0", "off"):
        return None
    try:
        k = int(raw)
    except ValueError:
        raise TorchMetricsUserError(
            f"{SCAN_ENV_VAR}={raw!r} is not a valid queue depth (expected unset/'0'/'off'"
            f" or an integer K in [2, {MAX_K}])"
        ) from None
    if not (2 <= k <= MAX_K):
        raise TorchMetricsUserError(
            f"{SCAN_ENV_VAR}={k} is out of range: K must be in [2, {MAX_K}]"
            " (K=1 is the unqueued engine — unset the variable instead)"
        )
    return k


def set_scan_steps(value: Optional[Any]) -> None:
    """Force the queue depth process-wide (``0``/``False`` = off); ``None`` restores
    env resolution."""
    global _k_override
    _k_override = _UNSET if value is None else coerce_k(value)


@contextmanager
def scan_context(k: int = 8) -> Generator[None, None, None]:
    """Scoped queue depth. Leaving the scope drains every queue with pending steps
    (reason ``scope-exit``) and restores the previous policy, also when a drain raises."""
    global _k_override
    prev = _k_override
    _k_override = coerce_k(k)
    try:
        yield
    finally:
        try:
            flush_all("scope-exit")
        finally:
            _k_override = prev


def k_bucket(n: int) -> int:
    """Smallest power of two holding ``n`` queued steps."""
    b = 1
    while b < n:
        b <<= 1
    return b


# ------------------------------------------------------------------ registry

_seq = iter(range(1, 1 << 62))
#: live queues, weakly held (a queue lives as long as its engine)
_QUEUES: "weakref.WeakValueDictionary[int, _ScanQueue]" = weakref.WeakValueDictionary()


def flush_metric(metric: Any, reason: str) -> int:
    """Drain every queue holding pending steps for ``metric``; the steps drained."""
    return sum(q.drain(reason) for q in list(_QUEUES.values()) if q.pending and q.owns(metric))


def flush_metrics(metrics: Sequence[Any], reason: str) -> int:
    """Drain every queue holding pending steps for any of ``metrics``."""
    return sum(
        q.drain(reason) for q in list(_QUEUES.values()) if q.pending and any(q.owns(m) for m in metrics)
    )


def flush_all(reason: str) -> int:
    """Drain every live queue (a scope exit)."""
    return sum(q.drain(reason) for q in list(_QUEUES.values()) if q.pending)


def discard_metric(metric: Any, reason: str) -> int:
    """Drop ``metric``'s pending steps without running them (the reset path). Only a
    queue the metric owns alone is discarded; a collection's fused queue also carries
    its siblings' steps, so it drains instead, and the reset wipes the metric's share."""
    dropped = 0
    for q in list(_QUEUES.values()):
        if q.pending and q.owns(metric):
            dropped += q.discard(reason) if q.exclusive_to((metric,)) else q.drain(reason)
    return dropped


def discard_metrics(metrics: Sequence[Any], reason: str) -> int:
    """A collection reset: queues owned within ``metrics`` drop their steps, a queue
    sharing members outside the set drains."""
    dropped = 0
    for q in list(_QUEUES.values()):
        if q.pending and any(q.owns(m) for m in metrics):
            dropped += q.discard(reason) if q.exclusive_to(metrics) else q.drain(reason)
    return dropped


# ------------------------------------------------------------------ slots and plans


def _record_scan(owner: str, ring: Any, kb: int) -> None:
    """The manifest row of a new ``kb`` graph: one step's input specs (a slot of each
    input ring, the bucket's rows) and ``k``, as the JAX scan records them."""
    _persist.record_compile(owner, "scan", args=[b[0] for b in ring.inputs], k=kb)


class _Ring:
    """A signature's input slots: ``slots`` steps of static inputs, the pad-row count
    of each, the step mask, the mask table it is set from, and the graphs over them by
    ``kb``. ``last_work`` is the last drain that read it (async rings)."""

    __slots__ = ("slots", "inputs", "rows", "n_pad", "pad_values", "valid", "masks", "graphs", "built", "last_work")

    def __init__(self, inputs: Sequence[torch.Tensor], bucket: Optional[int], slots: int) -> None:
        device = inputs[0].device
        self.slots = slots
        self.inputs = [
            torch.zeros((slots, *(bucketing.bucketed_shape(a, bucket) if bucket else a.shape)), dtype=a.dtype, device=device)
            for a in inputs
        ]
        self.rows = [0] * slots  # leading rows holding data, per slot
        self.n_pad = torch.zeros((slots,), dtype=torch.int32, device=device) if bucket else None
        self.pad_values = [0] * slots
        steps = torch.arange(slots, device=device)
        # masks[n]: the first n steps valid (made on the device: no host values)
        self.masks = steps[None, :] < torch.arange(slots + 1, device=device)[:, None]
        self.valid = torch.zeros((slots,), dtype=torch.bool, device=device)
        self.graphs: Dict[int, Tuple[Any, Dict[str, int]]] = {}
        self.built: Set[int] = set()  # kb run at least once (the CPU's "traces")
        self.last_work: Optional["_DrainWork"] = None

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self.inputs) + (self.n_pad.nbytes if self.n_pad is not None else 0)

    def fill(self, t: int, inputs: Sequence[torch.Tensor], bucket: Optional[int], stats: Any) -> int:
        """Copy one batch into slot ``t`` (zero tail for the pad rows); its row count."""
        n = bucketing.batch_size(inputs) if bucket is not None else 0
        with torch.no_grad():
            for buf, src in zip(self.inputs, inputs):
                dst = buf[t]
                if bucket is None or src.ndim == 0:
                    dst.copy_(src)
                else:
                    dst[:n].copy_(src)
                    if n < self.rows[t]:
                        dst[n : self.rows[t]].zero_()
                stats.input_copy_bytes += src.nbytes
            if bucket is not None:
                self.rows[t] = n
                pad = bucket - n
                if pad != self.pad_values[t]:
                    self.n_pad[t].fill_(pad)
                    self.pad_values[t] = pad
        return n

    def step_inputs(self, t: int, n: int, bucket: Optional[int]) -> List[torch.Tensor]:
        """Slot ``t`` as the batch it holds (``n`` rows when bucketed)."""
        if bucket is None:
            return [b[t] for b in self.inputs]
        return [b[t][:n] if b.ndim > 1 else b[t] for b in self.inputs]


class _Plan:
    """One queued signature: its members' plans (their static state buffers shared with
    the one-step engine) and its rings."""

    __slots__ = ("plans", "n_args", "kw_names", "bucket", "slots", "rings", "qkey")

    def __init__(self, plans: List[MemberPlan], n_args: int, kw_names: Tuple[str, ...], bucket: Optional[int], slots: int) -> None:
        self.qkey: Tuple = ()
        self.plans = plans
        self.n_args = n_args
        self.kw_names = kw_names
        self.bucket = bucket
        self.slots = slots
        self.rings: List[_Ring] = []

    @property
    def names(self) -> Set[str]:
        return {p.name for p in self.plans}

    def body(self, ring: _Ring, kb: int) -> None:
        """``kb`` masked steps over the ring's slots: what a scan graph holds."""
        bucketed = self.bucket is not None
        for t in range(kb):
            flat = [b[t] for b in ring.inputs]
            n_pad = ring.n_pad[t] if bucketed else None
            run_members(self.plans, flat, n_pad, self.n_args, self.kw_names, bucketed, valid=ring.valid[t])


class _DrainWork:
    """One swapped-out buffer: everything its drain needs, frozen at the swap."""

    __slots__ = (
        "queue", "plan", "ring", "rows", "reason", "done", "replay", "first_wait_t",
        "fill_event", "done_event", "device", "lineage", "context",
    )

    def __init__(self, queue: "_ScanQueue", plan: _Plan, ring: _Ring, rows: List[int], reason: str) -> None:
        self.queue = queue
        self.plan = plan
        self.ring = ring
        self.rows = rows  # per queued step, the rows its slot holds
        self.reason = reason
        self.done = threading.Event()
        self.replay = False  # the worker handed the steps back for a caller replay
        self.first_wait_t: Optional[float] = None
        self.fill_event: Any = None  # recorded on the caller's stream after the buffer's copies
        self.done_event: Any = None  # recorded on the side stream after the replay
        self.device = ring.inputs[0].device
        self.lineage: Optional[int] = None  # the causal span the swap took from the queue
        self.context: Any = None  # the submitter's context, which the worker runs in

    @property
    def steps(self) -> int:
        return len(self.rows)

    @property
    def settled(self) -> bool:
        return self.done.is_set() and not self.replay


# ------------------------------------------------------------------ queues


class _ScanQueue:
    """The queue and drain machinery one engine owns; ``MetricScan`` binds it to one
    metric's ``CompiledUpdate``, ``FusedScan`` to a collection's ``FusedUpdate``.

    Locking, as in the JAX module: ``_lock`` (reentrant) guards the pending buffer and
    the async FIFOs; ``_drain_mutex`` serializes drains of this queue. A caller may
    take the mutex while holding the lock; the worker takes the mutex without the lock
    and never waits on the caller, so the order is one-directional. The worker touches
    a metric's attributes only under ``_lock`` (the CPU's eager body); on the card it
    only replays.
    """

    def __init__(self, engine: Any) -> None:
        self._engine = engine
        self.stats = engine.stats
        self._pending: List[int] = []  # rows per queued step  # guarded-by: _lock
        self._plans: Dict[Tuple, Any] = {}  # signature -> _Plan or _FALLBACK
        self._qkey: Optional[Tuple] = None  # guarded-by: _lock
        self._plan: Optional[_Plan] = None  # guarded-by: _lock
        self._ring: Optional[_Ring] = None  # the ring the pending buffer fills  # guarded-by: _lock
        self._fast: Optional[Tuple] = None  # (raw key, qkey) of the last push
        self._fingerprints: Dict[Tuple, Dict[str, Any]] = {}  # built (qkey, kb) graphs
        self._lock = threading.RLock()
        self._drain_mutex = threading.Lock()
        #: called after a drain changed the members' bindings (a collection whose group
        #: owner queues on its own engine re-anchors its views)
        self.on_drain: Optional[Any] = None
        # --- async tier (engine/async_dispatch.py) ---
        self._async_limit: Optional[int] = None  # guarded-by: _lock
        self._staged: List[_DrainWork] = []  # swapped in push, submitted outside the lock
        self._needs_join = False  # guarded-by: _lock
        self._inflight: Deque[_DrainWork] = deque()  # guarded-by: _lock
        self._failed: Deque[_DrainWork] = deque()  # guarded-by: _lock
        self._poisoned = False  # guarded-by: _lock
        self._post_pending = False  # guarded-by: _lock
        self._last_done_event: Any = None  # guarded-by: _lock
        _QUEUES[next(_seq)] = self

    # -- what subclasses provide -----------------------------------------

    def owns(self, metric: Any) -> bool:
        raise NotImplementedError

    def exclusive_to(self, metrics: Sequence[Any]) -> bool:
        raise NotImplementedError

    def _members(self) -> Optional[List[Tuple[str, Any]]]:
        """The members a push may queue for, or None (counted) when it cannot queue."""
        raise NotImplementedError

    def _on_enqueued(self, plan: _Plan) -> Any:
        """The push's return value, after the host bookkeeping of an enqueue."""
        raise NotImplementedError

    def _refused(self) -> Any:
        """The push's return value when the step cannot queue."""
        raise NotImplementedError

    def _replay_step(self, plan: _Plan, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _post_drain(self) -> None:
        """After a drain changed the members' state bindings (a collection re-anchors its
        views)."""
        if self.on_drain is not None:
            self.on_drain()

    def _lineage_owners(self, plan: Optional[_Plan]) -> List[str]:
        """The owners whose watermarks a step of ``plan`` moves."""
        return [self.stats.owner]

    # -- queue core ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Steps not yet folded: the active buffer, in flight and handed back."""
        with self._lock:
            return len(self._pending) + sum(w.steps for w in self._inflight) + sum(w.steps for w in self._failed)

    @property
    def slot_bytes(self) -> int:
        """Device bytes held by the input slots of every queued signature."""
        return sum(r.nbytes for p in self._plans.values() if isinstance(p, _Plan) for r in p.rings)

    def push(self, args: Tuple[Any, ...], kwargs: Dict[str, Any], k: int, async_inflight: Optional[int] = None) -> Any:
        """Queue one step (copied into its slot). Submits and joins run outside the
        queue lock, so the worker can never deadlock against an enqueue."""
        if not async_inflight and (self._inflight or self._failed):
            # async turned off mid-stream: the background work lands first
            self.join_async("async-disabled")
        if async_inflight and not self._pending:
            self._free_ring_for_next_buffer(async_inflight)
        measuring = async_inflight and (_diag.active_recorder() is not None or _profile.active_profile() is not None)
        t0 = perf_counter() if measuring else 0.0
        with self._lock:
            self._async_limit = async_inflight or None
            result = self._push_locked(args, kwargs, k)
            staged, self._staged = self._staged, []
            needs_join, self._needs_join = self._needs_join, False
        for i, work in enumerate(staged):
            try:
                self._submit(work)
            except BaseException:
                for w in staged[i:]:
                    self._abandon(w)
                raise
        if needs_join:
            # a flush point inside the enqueue before an eager step: the swapped
            # buffer must land before the caller's eager step applies
            self.join_async("enqueue-ineligible")
        if measuring:
            # the caller's whole cost of an enqueue, submits and backpressure included
            _hist.observe(self.stats.owner, "async", "enqueue_us", round((perf_counter() - t0) * 1e6, 3))
        return result

    def _free_ring_for_next_buffer(self, limit: int) -> None:
        """Before a new buffer starts (outside the lock): if every ring of the current
        signature still holds an unsettled drain, join, so a ring's slots are never
        overwritten before its drain ran (or replayed, after a failure)."""
        plan = self._plan
        if plan is None:
            return
        with self._lock:
            busy = {id(w.ring) for w in (*self._inflight, *self._failed) if not w.settled}
            free = len(plan.rings) < limit + 1 or any(id(r) not in busy for r in plan.rings)
        if not free:
            self.join_async("ring-reuse")

    # tmlint: holds(_lock)
    def _push_locked(self, args: Tuple[Any, ...], kwargs: Dict[str, Any], k: int) -> Any:
        eng = self._engine
        st = self.stats
        if kwargs and not self._kwargs_ok():
            st.fallback("kwargs")
            self._flush_point("ineligible-step", asyncable=False)
            return self._refused()
        members = self._members()
        if members is None:
            self._flush_point("ineligible-step", asyncable=False)
            return self._refused()
        kw_names = tuple(sorted(kwargs))
        inputs = [*args, *(kwargs[n] for n in kw_names)]
        in_sig = eng._eligible_inputs(members, inputs)
        if in_sig is None:
            self._flush_point("ineligible-step", asyncable=False)
            return self._refused()
        bucket = eng._bucket(members, inputs)
        names = tuple(name for name, _ in members)
        raw = (len(args), kw_names, in_sig, names, k)
        fast = self._fast
        if fast is not None and self._pending and fast[0] == raw:
            qkey = fast[1]  # states cannot change while steps are queued: only drains write them
        else:
            if bucket is not None:
                in_sig = tuple((bucketing.bucketed_shape(a, bucket), a.dtype, a.device) for a in inputs)
            states = {name: step_state(m) for name, m in members}
            state_sig = tuple((name, state_signature(states[name])) for name, _ in members)
            # the placement joins the key (parallel/sharding.py): the carry is the local blocks
            placement = tuple(_sharding.metric_placement_token(m) for _, m in members)
            qkey = (len(args), kw_names, in_sig, bucket, names, k, placement, state_sig)
            plan = self._plans.get(qkey)
            if plan is None:
                if self._pending:
                    self._flush_point("signature-change", asyncable=True)
                plan = self._build_plan(qkey, members, states, inputs, k)
            if plan is _FALLBACK:
                st.fallback("uncompilable-signature")
                self._flush_point("ineligible-step", asyncable=False)
                return self._refused()
            if plan is None:
                self._flush_point("ineligible-step", asyncable=False)
                return self._refused()
            self._fast = (raw, qkey)
        if self._pending and qkey != self._qkey:
            self._flush_point("signature-change", asyncable=True)
        plan = self._plans[qkey]
        self._qkey = qkey
        self._plan = plan
        if not self._pending:
            self._ring = self._take_ring(plan, inputs)
        t = len(self._pending)
        self._pending.append(self._ring.fill(t, inputs, plan.bucket, st))
        result = self._on_enqueued(plan)
        if len(self._pending) >= k:
            self._flush_point("k-reached", asyncable=True)
        return result

    def _kwargs_ok(self) -> bool:
        return True

    def _build_plan(self, qkey: Tuple, members: List[Tuple[str, Any]], states: Dict[str, Dict[str, torch.Tensor]], inputs: List[torch.Tensor], k: int) -> Any:
        """A new signature's plan: its first ring, and the guarded probe of every member
        on slot 0 (``GraphEngine.prepare``: the warm-up a capture needs, its result
        discarded). Refused members leave the plan; too few leave the signature
        ``_FALLBACK``. A classified failure (out of memory) falls back for this step."""
        from torchmetrics_tpu_torch.engine import txn

        eng = self._engine
        n_args, kw_names, bucket = qkey[0], qkey[1], qkey[3]
        slots = k_bucket(k)
        try:
            ring = _Ring(inputs, bucket, slots)
            ring.fill(0, inputs, bucket, self.stats)
            plans, refused, _ = eng.prepare(
                members, [sig for _, sig in qkey[-1]], states, [b[0] for b in ring.inputs],
                ring.n_pad[0] if bucket is not None else None, bucket is not None, n_args, kw_names,
            )
        except _BuildFailed as failed:
            self.stats.fallback(f"scan-dispatch-{txn.classify_dispatch_error(failed.exc)}")
            return None
        except Exception as exc:  # noqa: BLE001 -- allocating the ring
            classified = txn.classify_dispatch_error(exc)
            if classified is None:
                raise
            self.stats.fallback(f"scan-dispatch-{classified}")
            return None
        demoted = len(plans) < eng.min_members
        eng._count_refusals(refused, demoted)
        if demoted:
            self._plans[qkey] = _FALLBACK
            return _FALLBACK
        plan = _Plan(plans, n_args, kw_names, bucket, slots)
        plan.qkey = qkey
        plan.rings.append(ring)
        self._plans[qkey] = plan
        return plan

    # tmlint: holds(_lock)
    def _take_ring(self, plan: _Plan, inputs: Sequence[torch.Tensor]) -> _Ring:
        """The ring the next buffer fills: ring 0 for synchronous drains; with async
        drains the first ring whose last drain settled, a new one when none has
        (at most ``inflight + 1``: ``push`` joins first otherwise). On the card the caller's stream then waits for that
        drain's replay before its slots are overwritten."""
        if not self._async_limit:
            return plan.rings[0]
        busy = {id(w.ring) for w in (*self._inflight, *self._failed) if not w.settled}
        ring = next((r for r in plan.rings if id(r) not in busy), None)
        if ring is None:
            ring = _Ring(inputs, plan.bucket, plan.slots)
            plan.rings.append(ring)
        last = ring.last_work
        if last is not None and last.done_event is not None:
            torch.cuda.current_stream(last.device).wait_event(last.done_event)
        return ring

    def discard(self, reason: str) -> int:
        """Drop the queued steps without running them (reset). Drains in flight finish
        first (the reset wipes them); handed-back steps are dropped too."""
        self.join_async(reason, collect=False)
        with self._lock:
            drops = [(self._plan, len(self._pending))] + [(w.plan, w.steps) for w in self._failed]
            n = sum(steps for _, steps in drops)
            self._failed.clear()
            self._poisoned = False
            if not n:
                return 0
            self._pending = []
        self.stats.scan_flushes += 1
        self.stats.scan_flush_reasons[reason] += 1
        for plan, steps in drops:
            for owner in self._lineage_owners(plan) if steps else ():
                # the dropped steps will never fold: they stop counting as staleness
                _lineage.note_discarded(owner, steps)
        _diag.record("scan.flush", self.stats.owner, reason=reason, steps=n, discarded=True)
        return n

    def drain(self, reason: str) -> int:
        """Fold every queued step into state: the join point of the async tier, then
        one replay of the pending buffer (on the worker when async is on)."""
        drained = self.join_async(reason)
        with self._lock:
            if not self._async_limit:
                return drained + self._drain_locked(reason)
            work = self._swap(reason)
            if work is not None:
                self._inflight.append(work)
        if work is None:
            return drained
        try:
            self._submit(work)
        except BaseException:
            self._abandon(work)
            raise
        self.join_async(reason)
        return drained + work.steps

    # tmlint: holds(_lock)
    def _drain_locked(self, reason: str) -> int:
        """A synchronous drain on this thread (queue lock held)."""
        work = self._swap(reason)
        if work is None:
            return 0
        self._bind(work)
        with self._drain_mutex:
            ok = self._execute(work, on_worker=False)
        if not ok:
            self._replay(work)
        self._post_drain()
        return work.steps

    # tmlint: holds(_lock)
    def _flush_point(self, reason: str, asyncable: bool) -> None:
        """A drain trigger inside a push (queue lock held): the async tier swaps the
        buffer out for the worker; a trigger before an eager step (``asyncable=False``)
        also joins before ``push`` returns."""
        if self._async_limit:
            work = self._swap(reason)
            if work is not None:
                self._inflight.append(work)
                self._staged.append(work)
            if not asyncable:
                self._needs_join = True
        else:
            self._drain_locked(reason)

    # tmlint: holds(_lock)
    def _swap(self, reason: str) -> Optional[_DrainWork]:
        """Detach the pending buffer as a work item."""
        rows = self._pending
        if not rows:
            return None
        self._pending = []
        st = self.stats
        st.scan_flushes += 1
        st.scan_flush_reasons[reason] += 1
        work = _DrainWork(self, self._plan, self._ring, rows, reason)
        self._ring.last_work = work
        # the open causal span leaves with the buffer and links its drain's events
        work.lineage = _lineage.take_span(st.owner)
        span = {} if work.lineage is None else {"lineage": work.lineage}
        _diag.record("scan.flush", st.owner, reason=reason, steps=len(rows), **span)
        return work

    def _bind(self, work: _DrainWork) -> None:
        """Caller side of a drain: each member's states and riders onto its buffers
        (copied in where they are not the buffers yet, other holders shielded), and the
        step mask from the mask table. Both on the caller's stream; then, for a
        background drain, the fill event the worker's stream waits on."""
        st = self.stats
        with self._lock:
            for plan in work.plan.plans:
                state = step_state(plan.metric)
                shield_state(plan.metric, plan.buffers, st)
                copy_into_buffers(state, plan.buffers, st)
                bind_buffers(plan.metric, state, plan.buffers)
            with torch.no_grad():
                work.ring.valid.copy_(work.ring.masks[work.steps])

    def _needs_copy(self, work: _DrainWork) -> bool:
        with self._lock:
            for plan in work.plan.plans:
                state = step_state(plan.metric)
                if any(state[k] is not buf for k, buf in plan.buffers.items()):
                    return True
        return False

    def _execute(self, work: _DrainWork, on_worker: bool) -> bool:
        """One drain: the ``kb`` graph's replay (captured first on the caller's thread
        when new) or, on the CPU, the masked body. False: the steps must replay one at a
        time (counted)."""
        plan, ring, n = work.plan, work.ring, work.steps
        kb = k_bucket(n)
        st = self.stats
        eng = self._engine
        rec = _diag.active_recorder()
        profiling = _profile.active_profile() is not None
        measuring = rec is not None or profiling
        gkey = (plan.qkey, kb)
        scope = annotation_scope(st.owner, "scan", gkey)
        t_dispatch = perf_counter() if measuring else 0.0
        probing = False
        events = None
        try:
            if work.device.type == "cuda":
                entry = ring.graphs.get(kb)
                first = entry is None
                if first:
                    if eng._pool is None:
                        eng._pool = torch.cuda.graph_pool_handle()
                    _persist.lookup_executable(st, st.owner, "scan", _costs.key_digest(gkey), work.device)
                    t_build = perf_counter()
                    try:
                        entry, capture_ms, pool_bytes = measured_capture(lambda: plan.body(ring, kb), eng._pool, work.device)
                        ring.graphs[kb] = entry
                    except BaseException:
                        eng._pool = None  # a failed capture may leave its pool recording
                        raise
                    _costs.record_build(
                        st.owner, "scan", _costs.key_digest(gkey), (perf_counter() - t_build) * 1e3,
                        inputs=ring.inputs, states=[b for p in plan.plans for b in p.buffers.values()],
                        capture_ms=capture_ms, pool_bytes=pool_bytes,
                    )
                    _record_scan(st.owner, ring, kb)
                else:
                    probing = profiling and _profile.probe_due(st.owner, "scan")
                    events = probe_events(work.device) if probing else None
                graph, launches = entry
                if measuring:
                    t_dispatch = perf_counter()
                if on_worker:
                    from torchmetrics_tpu_torch.engine import async_dispatch

                    side = async_dispatch.side_stream(work.device)
                    with torch.cuda.device(work.device), torch.cuda.stream(side):
                        side.wait_event(work.fill_event)
                        with timed_replay(scope, work.device, events):
                            graph.replay()
                        work.done_event = torch.cuda.Event()
                        work.done_event.record(side)
                else:
                    with timed_replay(scope, work.device, events):
                        graph.replay()
            else:
                first = kb not in ring.built
                probing = profiling and not first and _profile.probe_due(st.owner, "scan")
                if first:
                    _persist.lookup_executable(st, st.owner, "scan", _costs.key_digest(gkey), work.device)
                t_build = perf_counter()
                if on_worker:
                    with self._lock:  # the eager body swaps the metrics' states
                        plan.body(ring, kb)
                else:
                    plan.body(ring, kb)
                ring.built.add(kb)
                launches = None
                if first:
                    _costs.record_build(
                        st.owner, "scan", _costs.key_digest(gkey), (perf_counter() - t_build) * 1e3,
                        inputs=ring.inputs, states=[b for p in plan.plans for b in p.buffers.values()],
                    )
                    _record_scan(st.owner, ring, kb)
        except Exception as exc:  # noqa: BLE001 -- the steps are intact in their slots: replay them
            from torchmetrics_tpu_torch.engine import txn

            if on_worker:
                raise
            classified = txn.classify_dispatch_error(exc)
            st.fallback(f"scan-dispatch-{classified}" if classified else f"scan-failed:{type(exc).__name__}")
            return False
        device_us = event_us = None
        if probing:
            device_us, event_us = completion_probe(st.owner, "scan", st, t_dispatch, events)
        with self._lock:
            if launches is not None:
                ops.add_launches(launches)
                st.replays += 1
                st.captures += first
            st.traces += first
            st.cache_hits += not first
            st.dispatches += 1
            st.scan_dispatches += 1
            st.scan_steps_folded += n
            st.scan_pad_steps += kb - n
            st.metrics_updated += n * len(plan.plans)
            eng._count_riders(plan.plans, n)
            if work.done_event is not None:
                self._last_done_event = work.done_event
        for owner in self._lineage_owners(plan):
            _lineage.note_folded(owner, n)
        if first and gkey not in self._fingerprints:  # a second ring's graph is no rebuild
            fp = signature_fingerprint((plan.bucket, plan.n_args, plan.kw_names, plan.qkey[-1], plan.qkey[2]))
            fp["bucket"] = (plan.bucket, kb)
            note_build(st, "update.scan", self._fingerprints, gkey, fp, k_bucket=kb)
        if measuring:
            dispatch_us = round((perf_counter() - t_dispatch) * 1e6, 3)
            _hist.observe(st.owner, "scan", "dispatch_us", dispatch_us)
            span = {} if work.lineage is None else {"lineage": work.lineage}
            _diag.record(
                "update.scan", st.owner, dispatch_us=dispatch_us, steps=n, k_bucket=kb, pad_steps=kb - n,
                cached=not first, reason=work.reason, **span,
            )
            if device_us is not None:
                probe = {"device_event_us": event_us} if event_us is not None else {}
                _diag.record("update.scan.probe", st.owner, dispatch_us=dispatch_us, device_us=device_us, **probe)
        if profiling and not first:
            from torchmetrics_tpu_torch.engine import numerics

            for p in plan.plans:
                if p.comp is not None:
                    numerics.maybe_drift_probe(p.metric, st, owner=f"{st.owner}:{p.name}" if p.name else None)
        return True

    def _replay(self, work: _DrainWork) -> None:
        """The one-step-at-a-time fallback, in order, from the slots: never lost. The
        replayed steps fold, and the record flags them as ``replayed``."""
        plan = work.plan
        for t, rows in enumerate(work.rows):
            flat = work.ring.step_inputs(t, rows, plan.bucket)
            self._replay_step(plan, tuple(flat[: plan.n_args]), dict(zip(plan.kw_names, flat[plan.n_args :])))
        for owner in self._lineage_owners(plan):
            _lineage.note_folded(owner, work.steps)
            _lineage.note_excluded(owner, "replayed", work.steps)

    # -- async tier (engine/async_dispatch.py) ---------------------------

    def _submit(self, work: _DrainWork) -> None:
        """Hand a swapped buffer to the worker, under backpressure; a buffer whose graph
        is not captured yet drains here on the caller's thread, after the older ones."""
        from torchmetrics_tpu_torch.engine import async_dispatch

        st = self.stats
        if self._needs_copy(work):
            self._join_until(work)  # nothing may write the buffers while they are copied in
        self._bind(work)
        cuda = work.device.type == "cuda"
        if cuda:
            work.fill_event = torch.cuda.Event()
            work.fill_event.record(torch.cuda.current_stream(work.device))
        kb = k_bucket(work.steps)
        if cuda and kb not in work.ring.graphs or not cuda and kb not in work.ring.built:
            # the first drain of a (ring, kb) pair captures on the caller's thread
            self._join_until(work)
            try:
                with self._drain_mutex:
                    ok = self._execute(work, on_worker=False)
                if not ok:
                    self._replay(work)
                    work.replay = True
                self._post_drain()
            finally:
                work.done.set()
            return
        limit = self._async_limit or 1
        while True:
            with self._lock:
                while self._inflight and self._inflight[0].done.is_set() and self._inflight[0] is not work:
                    self._inflight.popleft()
                oldest = self._inflight[0] if len(self._inflight) > limit else None
                poisoned = self._poisoned
            if poisoned:
                # the worker hands payloads back: settle everything in order here
                with self._lock:
                    try:
                        self._inflight.remove(work)
                    except ValueError:
                        pass
                self.join_async("async-poisoned")
                self._replay(work)
                st.async_replayed_steps += work.steps
                self._post_drain()
                work.replay = True
                work.done.set()
                return
            if oldest is None or oldest is work:
                break
            st.async_backpressure_waits += 1
            if oldest.first_wait_t is None:
                oldest.first_wait_t = perf_counter()
            oldest.done.wait()
        with self._lock:
            st.async_submits += 1
            depth = len(self._inflight)
        rec = _diag.active_recorder()
        if rec is not None or _profile.active_profile() is not None:
            # how far the caller runs ahead of the drains (the backpressure ceiling at most)
            _hist.observe(st.owner, "async", "depth", float(depth))
            if rec is not None:
                span = {} if work.lineage is None else {"lineage": work.lineage}
                rec.record("async.enqueue", st.owner, steps=work.steps, depth=depth, reason=work.reason, **span)
        async_dispatch.submit(work)

    def _join_until(self, work: _DrainWork) -> None:
        """Wait out (and settle) everything swapped before ``work``."""
        while True:
            with self._lock:
                while self._inflight and self._inflight[0].done.is_set() and self._inflight[0] is not work:
                    self._inflight.popleft()
                head = self._inflight[0] if self._inflight else None
            if head is None or head is work:
                break
            if head.first_wait_t is None:
                head.first_wait_t = perf_counter()
            head.done.wait()
        self._collect_failed()
        self._wait_stream()

    def _abandon(self, work: _DrainWork) -> None:
        """A buffer that can no longer reach the worker: to the failed FIFO (the next
        join replays it)."""
        if work.done.is_set():
            return
        with self._lock:
            work.replay = True
            self._failed.append(work)
        work.done.set()

    def worker_execute(self, work: _DrainWork) -> None:
        """The background half of a drain (the executor's thread). A failure hands the
        steps back for the next caller-side join to replay, and stops later buffers
        from running ahead of them."""
        st = self.stats
        with self._lock:
            if self._poisoned:
                work.replay = True
                self._failed.append(work)
                return
        t0 = perf_counter()
        try:
            with self._drain_mutex:
                self._execute(work, on_worker=True)
        except Exception as exc:  # noqa: BLE001 -- handed back to the caller
            with self._lock:
                work.replay = True
                self._failed.append(work)
                self._poisoned = True
                st.fallback(f"scan-async-failed:{type(exc).__name__}")
            return
        end = perf_counter()
        fw = work.first_wait_t
        overlap_us = max(0.0, ((min(fw, end) if fw is not None else end) - t0) * 1e6)
        with self._lock:
            st.async_dispatches += 1
            st.async_overlap_us += int(overlap_us)
            self._post_pending = True
        span = {} if work.lineage is None else {"lineage": work.lineage}
        _diag.record(
            "async.drain", st.owner, dispatch_us=round((end - t0) * 1e6, 3), overlap_us=round(overlap_us, 3),
            steps=work.steps, reason=work.reason, **span,
        )

    def join_async(self, reason: str, collect: bool = True) -> int:
        """Wait out this queue's background drains (the JOIN, on the observer's thread):
        the FIFO dry on the host, then the caller's stream waits for the last replay (a
        stream wait, not a device sync); handed-back steps replay here (unless
        ``collect=False``, the discard path). Returns the steps settled."""
        settled = 0
        waited = False
        t0 = 0.0
        last_span: Optional[int] = None
        while True:
            with self._lock:
                while self._inflight and self._inflight[0].done.is_set():
                    self._inflight.popleft()
                work = self._inflight[0] if self._inflight else None
            if work is None:
                break
            if not waited:
                waited, t0 = True, perf_counter()
            if work.first_wait_t is None:
                work.first_wait_t = perf_counter()
            work.done.wait()
            if not work.replay:
                settled += work.steps
                if work.lineage is not None:
                    last_span = work.lineage
        st = self.stats
        if waited:
            wait_us = (perf_counter() - t0) * 1e6
            with self._lock:
                st.async_joins += 1
                st.async_join_wait_us += int(wait_us)
            span = {} if last_span is None else {"lineage": last_span}
            _diag.record("async.join", st.owner, reason=reason, steps=settled, wait_us=round(wait_us, 3), **span)
        self._wait_stream()
        if collect:
            settled += self._collect_failed()
        with self._lock:
            post, self._post_pending = self._post_pending, False
        if post:
            self._post_drain()
        return settled

    def _wait_stream(self) -> None:
        with self._lock:
            ev, self._last_done_event = self._last_done_event, None
        if ev is not None:
            torch.cuda.current_stream(self._engine_device()).wait_event(ev)

    def _engine_device(self) -> torch.device:
        plan = self._plan
        return plan.rings[0].inputs[0].device if plan is not None else torch.device("cuda")

    def _collect_failed(self) -> int:
        """Replay handed-back steps in FIFO order on this thread."""
        replayed = 0
        while True:
            with self._lock:
                if not self._failed:
                    self._poisoned = False
                    break
                work = self._failed.popleft()
            self._replay(work)
            self.stats.async_replayed_steps += work.steps
            replayed += work.steps
        if replayed:
            self._post_drain()
        return replayed


class MetricScan(_ScanQueue):
    """The scan queue of one metric's ``CompiledUpdate``."""

    def owns(self, metric: Any) -> bool:
        return metric is self._engine._metric

    def exclusive_to(self, metrics: Sequence[Any]) -> bool:
        return any(self._engine._metric is m for m in metrics)

    def _members(self) -> Optional[List[Tuple[str, Any]]]:
        m = self._engine._metric
        if not self._pending and not all(isinstance(getattr(m, k), torch.Tensor) for k in m._defaults):
            self.stats.fallback("non-tensor-state")
            return None
        return [("", m)]

    def _on_enqueued(self, plan: _Plan) -> bool:
        _lineage.note_enqueued(self.stats.owner)
        return True  # the metric's update wrapper did the bookkeeping

    def _refused(self) -> bool:
        return False

    def _replay_step(self, plan: _Plan, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        m = self._engine._metric
        if not self._engine.step(args, kwargs):
            m._run_eager_update(args, kwargs)


class FusedScan(_ScanQueue):
    """The scan queue of a collection's ``FusedUpdate``: the handled set of a push is
    the signature's plan members, decided by the probe before anything queues."""

    def owns(self, metric: Any) -> bool:
        return any(m is metric for _, m in self._engine.metrics)

    def exclusive_to(self, metrics: Sequence[Any]) -> bool:
        plan = self._plan
        covered = [p.metric for p in plan.plans] if plan is not None else [m for _, m in self._engine.metrics]
        return all(any(m is c for c in metrics) for m in covered)

    def _kwargs_ok(self) -> bool:
        return False  # per-member kwarg filtering inside one graph is not supported

    def _members(self) -> Optional[List[Tuple[str, Any]]]:
        members = self._engine.eligible_members()
        if len(members) < self._engine.min_members:
            self.stats.fallback("too-few-members")
            return None
        return members

    def _on_enqueued(self, plan: _Plan) -> Set[str]:
        # the host bookkeeping of the one-step fused writeback, done at the enqueue:
        # the count does not depend on observation (a state read drains first)
        for p in plan.plans:
            p.metric._computed = None
            p.metric._update_count += 1
            # per member (observation sites key by type name); the span lives on the queue
            _lineage.note_enqueued(type(p.metric).__name__, span=False)
        _lineage.open_span(self.stats.owner)
        return plan.names

    def _lineage_owners(self, plan: Optional[_Plan]) -> List[str]:
        members = plan.plans if plan is not None else []
        return [type(p.metric).__name__ for p in members]

    def _refused(self) -> Optional[Set[str]]:
        return None

    def _replay_step(self, plan: _Plan, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        for p in plan.plans:  # update counts advanced at the enqueue
            p.metric._run_eager_update(args, kwargs)

    def _post_drain(self) -> None:
        cb = getattr(self._engine, "on_scan_drain", None)
        if cb is not None:
            cb()
