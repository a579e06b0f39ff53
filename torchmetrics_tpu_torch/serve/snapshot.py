"""Pause-free snapshot-compute (counterpart of ``torchmetrics_tpu/serve/snapshot.py``).

A scrape that called ``compute()`` on the live metric would sync, cache and perhaps
unsync mid-stream. This module makes a scrape a read of a copy instead:

1. :func:`take_snapshot` takes the state at a consistent watermark and copies each
   tensor on the card. The copy is enqueued while no mutation is in flight: the
   scrape asks the metric's gate (``metric.quiesced``) and waits for its
   ``_mutation_depth`` to reach 0, an update that would begin meanwhile waits until
   the copy is enqueued, which takes microseconds, and then goes before the next
   snapshot. The JAX package polls the depth between short sleeps instead; in the port that
   starves against a back-to-back loop, whose torch calls release the interpreter
   lock mid-update. The watermark is checked again after the copy; a failed attempt
   retries, up to ``TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES`` attempts.
2. :func:`snapshot_compute` runs the metric's raw compute body on a cached scratch
   clone holding the copy. It is rank-local: nothing syncs, nothing unsyncs, and the
   live metric's caches and counters are untouched.

**The copy is ordered on the stream, not guarded by donation.** The JAX copy is
donation-proof: the hot loop's next donated step consumes the old buffers. The port's
engine writes its static state buffers in place at every replay, on the updating
thread's stream, so the copy (``clone``) is enqueued on the stream that last wrote
the state (``Metric._write_stream``, recorded as each update or forward ends; a
collection's step records it on its members). That stream first waits on the
scrape's own, where the flush joined any drain of the async worker's side stream.
The next update's writes follow the copy on the writer's stream; the scrape's stream
then waits on the copy, and the allocator is told of each cross-stream use
(``record_stream``).

The flight recorder narrates both halves (``serve.snapshot`` and
``serve.snapshot.read``, the read carrying ``updates_between``: the updates that
landed while the snapshot computed).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable, Dict, Iterable

import torch

from torchmetrics_tpu_torch.diag import lineage as _lineage
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.metric import quiesced
from torchmetrics_tpu_torch.serve import stats as _serve_stats
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["StateSnapshot", "read_host", "snapshot_compute", "take_snapshot"]

#: scratch clones per live metric, built once and reused per scrape:
#: ``id(metric) -> (weakref(metric), scratch, lock)``. The weakref's callback evicts
#: the entry when the metric dies; the liveness check guards against id reuse.
_SCRATCH: Dict[int, Any] = {}  # guarded-by: _SCRATCH_LOCK
_SCRATCH_LOCK = threading.Lock()
#: the longest one attempt waits for an update in flight to end
_QUIET_WAIT_S = 1.0


@dataclass
class StateSnapshot:
    """A copy of one metric's state at a known watermark."""

    state: Dict[str, Any]
    update_count: int
    retries: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)
    #: what the snapshot covers (``diag/lineage.py``'s ``ValueProvenance.as_dict()``);
    #: empty when the provenance plane is off
    provenance: Dict[str, Any] = field(default_factory=dict)


def _copy_leaf(value: Any) -> Any:
    if isinstance(value, list):
        return [v.clone() if isinstance(v, torch.Tensor) else v for v in value]
    return value.clone()


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _on_writer_stream(metric: Any, build: Callable[[], Any], reads: Any) -> Any:
    """``build()`` with its kernels enqueued on the stream that last wrote ``metric``'s
    state (the device's default stream before any write), after this thread's stream;
    this thread's stream then waits on them. ``reads`` are the state tensors ``build``
    reads: the allocator learns of their use on the writer's stream."""
    device = metric.device
    if device.type != "cuda":
        return build()
    current = torch.cuda.current_stream(device)
    writer = getattr(metric, "_write_stream", None) or torch.cuda.default_stream(device)
    if writer == current:
        return build()
    writer.wait_stream(current)  # a drain the flush joined, ordered on this thread's stream
    with torch.cuda.stream(writer):
        out = build()
    for t in _tensors(reads):
        t.record_stream(writer)
    current.wait_stream(writer)
    for t in _tensors(out):
        t.record_stream(current)
    return out


def _copy_extras(extras: Dict[str, Any]) -> Dict[str, Any]:
    return {k: ({a: _copy_leaf(r) for a, r in v.items()} if isinstance(v, dict) else _copy_leaf(v)) for k, v in extras.items()}


def take_snapshot(metric: Any) -> StateSnapshot:
    """A consistent copy of ``metric``'s state, taken without pausing its updates
    for longer than the copy takes to enqueue.

    The scan queue is flushed first (a snapshot holds every enqueued step). A
    snapshot that stays inconsistent over the whole retry budget raises: a scrape
    never surfaces a torn state as a value.
    """
    from torchmetrics_tpu_torch.engine import numerics, txn
    from torchmetrics_tpu_torch.engine.scan import flush_metric

    flush_metric(metric, "observation:snapshot")
    budget = _serve_stats.snapshot_retries()
    last_exc: Any = None
    for attempt in range(budget):
        with quiesced(metric, _QUIET_WAIT_S) as quiet:
            if not quiet:
                continue  # an update stayed in flight (on this very thread, or stalled)
            watermark = metric._update_count
            refs = {}
            for key in metric._defaults:
                value = getattr(metric, key)
                refs[key] = list(value) if isinstance(value, list) else value
            extras: Dict[str, Any] = {}
            quarantined = metric.__dict__.get(txn.ATTR)
            if quarantined is not None:
                extras[txn.ATTR] = quarantined
            residuals = metric.__dict__.get(numerics.ATTR)
            if residuals:
                extras[numerics.ATTR] = dict(residuals)
            try:
                copies, extra_copies = _on_writer_stream(
                    metric, lambda: ({k: _copy_leaf(v) for k, v in refs.items()}, _copy_extras(extras)), (refs, extras)
                )
            except RuntimeError as exc:
                last_exc = exc
                continue
            if metric._update_count != watermark or metric._mutation_depth:
                continue  # an update got past the gate (a stalled snapshot's timeout)
        _diag.record("serve.snapshot", type(metric).__name__, update_count=int(watermark), retries=attempt)
        _serve_stats.note_snapshot(attempt)
        # the snapshot is an observation: the queue flushed above, so the record
        # attests exactly what the copied state covers
        record = _lineage.observe_metric(metric, "snapshot")
        return StateSnapshot(
            state=copies, update_count=int(watermark), retries=attempt, extras=extra_copies,
            provenance=record.as_dict() if record is not None else {},
        )
    raise TorchMetricsUserError(
        f"Could not take a consistent snapshot of {type(metric).__name__} within"
        f" {budget} attempts (TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES); an update stayed"
        f" in flight." + (f" Last error: {last_exc}" if last_exc else "")
    )


def read_host(metric: Any, attrs: Any, index: Any = None) -> Dict[str, Any]:
    """Scrape-path host read of named states with the snapshot's protocol.

    The serving views (tenant tables, sketch registers) read live buffers; this shares
    :func:`take_snapshot`'s gate for reads that need a few numpy arrays: the rows are
    copied on the card while no update is in flight, and moved to the host after the
    gate has let the updates go on. The fetch rides the sanctioned ``serve-scrape``
    boundary. ``index`` selects ``state[index]`` on the card before the transfer: a
    per-tenant view moves one row per state, not the capacity-sized table.
    """
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed
    from torchmetrics_tpu_torch.engine.scan import flush_metric

    # the scrape views must reflect every enqueued step
    flush_metric(metric, "observation:scrape")
    _lineage.observe_metric(metric, "scrape")
    attrs = tuple(attrs)
    budget = _serve_stats.snapshot_retries()
    last_exc: Any = None
    for _attempt in range(budget):
        with quiesced(metric, _QUIET_WAIT_S) as quiet:
            if not quiet:
                continue
            watermark = metric._update_count
            refs = {a: getattr(metric, a) for a in attrs}
            try:
                rows = _on_writer_stream(
                    metric, lambda: {a: (v if index is None else v[index]).clone() for a, v in refs.items()}, refs
                )
            except RuntimeError as exc:
                last_exc = exc
                continue
            if metric._update_count != watermark or metric._mutation_depth:
                continue
        with transfer_allowed("serve-scrape"):
            return {a: v.detach().cpu().numpy() for a, v in rows.items()}
    raise TorchMetricsUserError(
        f"Could not read {attrs} from {type(metric).__name__} within {budget}"
        f" attempts (TORCHMETRICS_TPU_SERVE_SNAPSHOT_RETRIES)."
        + (f" Last error: {last_exc}" if last_exc else "")
    )


def _scratch_for(metric: Any) -> Any:
    """The cached compute-only clone for this metric instance (built once)."""
    key = id(metric)
    with _SCRATCH_LOCK:
        entry = _SCRATCH.get(key)
        if entry is None or entry[0]() is not metric:
            scratch = metric.clone()
            # scrape computes are rank-local reads: never sync, never cache
            scratch.sync_on_compute = False
            scratch._to_sync = False
            scratch.compute_with_cache = False

            def _evict(_ref: Any, _key: int = key) -> None:
                # lock-free: the callback can fire from the collector inside the
                # locked clone above; dict.pop is atomic under the interpreter lock
                _SCRATCH.pop(_key, None)

            # the per-entry lock serializes concurrent scrapes of one metric
            _SCRATCH[key] = entry = (weakref.ref(metric, _evict), scratch, threading.Lock())
    return entry


def snapshot_compute(metric: Any, snapshot: StateSnapshot = None) -> Any:
    """``compute()`` on a copy while the live metric keeps updating.

    Returns the value at the snapshot's watermark. The live metric's state, caches
    and sync status are untouched; the ``serve.snapshot.read`` event records how many
    updates landed between the copy and the read.
    """
    if snapshot is None:
        snapshot = take_snapshot(metric)
    _ref, scratch, lock = _scratch_for(metric)
    t0 = perf_counter()
    with lock:
        prior = dict(scratch.__dict__)
        try:
            for key, value in snapshot.state.items():
                object.__setattr__(scratch, key, value)
            for key, value in snapshot.extras.items():
                object.__setattr__(scratch, key, value)
            object.__setattr__(scratch, "_update_count", max(snapshot.update_count, 1))
            object.__setattr__(scratch, "_computed", None)
            value = scratch._raw_compute()
        finally:
            scratch.__dict__.clear()
            scratch.__dict__.update(prior)
    span = snapshot.provenance.get("span") if snapshot.provenance else None
    _diag.record(
        "serve.snapshot.read", type(metric).__name__,
        update_count=snapshot.update_count,
        updates_between=int(metric._update_count) - snapshot.update_count,
        compute_us=round((perf_counter() - t0) * 1e6, 3),
        **({} if span is None else {"lineage": span}),
    )
    return value
