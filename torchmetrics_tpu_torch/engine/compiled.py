"""Compiled-step cache on CUDA graphs (counterpart of ``torchmetrics_tpu/engine/compiled.py``).

A metric's ``update`` rebinds ``self.<state>`` attributes. The engine re-expresses one
update as a function ``state -> state`` (``traced_update``: swap the state in, run the
original update body, collect the state attributes, restore the metric's
``__dict__``) and builds it once per signature: (bucket, argument layout, state
shapes and dtypes, input shapes and dtypes). Where the JAX package jits that function
with the state donated, the port captures it into a ``torch.cuda.CUDAGraph``.
``GraphEngine`` does this over one or more metrics fed by one batch: ``CompiledUpdate``
is the one-metric case, ``engine/fusion.py``'s ``FusedUpdate`` a collection's owners.

- **Fixed addresses.** Each signature owns static input buffers (and, when bucketed,
  a static int32 ``n_pad`` scalar); the engine owns one set of static state buffers
  per member and state signature, shared by all its graphs. A step copies the batch
  into the input buffers (zero tail for the bucket's pad rows) and replays the graph,
  which writes the new state into the state buffers in place. The metric's state
  attributes ARE those buffers afterwards (the counterpart of donation), so the next
  step copies nothing; a state that is not its buffer (after ``reset``, ``forward``'s
  swap to defaults, ``load_state_dict``, ``merge_state``, ``unsync``) is copied in
  first and counted as ``donation_copies``.
- **Holders of state references.** A buffer written in place must not be held
  elsewhere: ``Metric._copy_state_refs`` (the ``sync`` snapshot, ``forward``'s global
  state) clones static buffers, ``compute`` never returns a tensor that shares a
  buffer's storage, and ``shield_state`` gives any other holder it finds
  (``protected_ids``: the registered defaults, ``_cache``, ``_computed``,
  ``_forward_cache``) a copy before a replay. A reference the caller took itself is
  not among them: after ``h = m.tp; m.update(...)`` under the engine, ``h`` is the
  buffer and holds the new count. In the JAX package the donation deletes ``h``
  instead, and reading it raises. The port keeps this difference and does not copy
  the states on every step to hide it.
- **Eligibility without a tracer.** The first step of a signature runs each member's
  update under ``_Guard``, a ``TorchDispatchMode`` that raises ``_Ineligible`` on every
  operation that reads a value on the host or sizes an output from data
  (``.item()`` / ``bool()`` / ``.tolist()``, ``nonzero``, ``unique``, ``bincount``,
  boolean indexing, a copy between the host and the card, host data entering the
  update). The guard sees the same operations on the CPU and on the card, so both
  agree on what is eligible. A refused member is left out of the signature; a
  signature left with too few members is cached as ``_FALLBACK`` and every later
  step with it is a counted eager fallback. That guarded step is also the warm-up a
  capture needs (the kernel build, plan caches, device queries) and its result is
  the step's result.
- **Capture.** On a CUDA device an eligible signature is then captured
  (``capture_error_mode="thread_local"``, one memory pool per engine); a capture
  error is a fault and raises. A CUDA metric with the engine on never runs the step
  outside its graph after the warm-up. On the CPU there is nothing to capture: each
  later step runs the same step body eagerly and writes into the same static
  buffers, so the CPU tests see the aliasing the card has.
- **Launch accounting.** A replay launches the kernels recorded in its graph without
  calling their wrappers, so the capture records how many launches of each kernel a
  graph holds (``ops.launch_counts``) and each replay adds them.
- **Riders.** The step body is JAX ``make_step_body``'s order, written once
  (``member_update`` then ``write_step``) and held by the one-step graphs and by each
  step of a scan graph (``engine/scan.py``): the update, the pad-subtract identity, the
  compensated two-sum (``engine/numerics.py``), the quarantine transaction
  (``engine/txn.py``), the health sentinel's fold (``diag/sentinel.py``: over the
  final, post-transaction states, with ``input_poisoned`` and ``precision_loss``). The
  riders' tensors (the sentinel bitmask, the quarantine counter, the residuals) join
  the step's state under reserved keys (``statespec.RIDER_KEYS``, exempt from
  pad-subtract) and get static buffers like the states, written in place by a replay. A
  step with riders computes each candidate in full before it writes a buffer, so the
  transaction selects against the intact pre-step values.
- **The signature manifest** (``engine/persist.py``). With persistence on, a build first
  asks for a persisted graph (a counted miss: a graph does not load), and a build that
  succeeds appends its row: kind ``update`` or ``fused``, the caller's inputs (not the
  bucket-padded static buffers) and the bucket. The CPU, which captures nothing, records
  too. ``prewarm`` replays the rows on zero inputs.
- **Diagnostics.** A step is the spans ``engine.key``, then ``engine.build`` or
  ``engine.stage`` and ``engine.replay``, then ``engine.bind`` (``diag/trace.py``).
  With a flight recorder or a profile active (``diag/``), a step records
  ``<kind>.trace`` / ``<kind>.retrace`` (the cause attributed by ``attribute_retrace``
  over ``signature_fingerprint`` and counted in ``retrace_causes``) and
  ``<kind>.dispatch`` (``kind`` is ``update`` or ``fused``; ``dispatch_us`` from the
  build's or the replay's start to the bind's end), and feeds the ``dispatch_us``
  histogram. Every replay runs in the
  ``tm:<owner>:<kind>:<signature>`` scope (``diag/profile.dispatch_scope``). Under a
  profile every Nth warm step is a completion probe (``completion_probe``: CUDA events
  around the replay, a sanctioned wait; ``<kind>.probe``, ``device_us``,
  ``device_event_us``), followed by the drift audit of the compensated members. Each
  build lands in the cost ledger (``diag/costs.py``).
- **The fallback ladder.** A classified failure while building a signature (an
  out-of-memory error allocating its static inputs, in its warm-up or in its capture,
  which ends cleanly and releases the graph's memory) retries the batch as
  half-bucket chunks, then eagerly, for this step only (``CompiledUpdate._ladder_step``);
  an unclassified capture error still raises.

- **Sharded state** (``parallel/sharding.py``): a step reads a placed state's local block
  (``step_state``) and writes the buffer back wrapped as the metric's ``DTensor``
  (``bind_buffers``), so a graph captures and replays over local blocks alone, and the
  placement joins the cache key (``sharding.metric_placement_token``; "" until a state is
  placed).

Anything that cannot run as a fixed graph (list states, non-tensor inputs, a wrapper
holding inner metrics, a side effect on a non-state attribute, a host read) falls back
to the eager path and is counted in ``EngineStats``.

Left out against the JAX engine: the donation switch (a graph always writes its
buffers in place).
``state_invalidated`` has no counterpart: no step consumes a buffer here, and a first
step writes no state until the guard has passed.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager, nullcontext
from time import perf_counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torchmetrics_tpu_torch import ops
from torchmetrics_tpu_torch.diag import costs as _costs
from torchmetrics_tpu_torch.diag import hist as _hist
from torchmetrics_tpu_torch.diag import profile as _profile
from torchmetrics_tpu_torch.diag import sentinel as _sentinel
from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine import bucketing, config
from torchmetrics_tpu_torch.engine import persist as _persist
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.parallel import sharding as _sharding
from torchmetrics_tpu_torch.utilities.data import apply_to_collection

_FALLBACK = object()  # cache sentinel: this signature is known to be ineligible

#: the tensor attribute that marks an engine's static state buffer
STATIC_MARK = "_engine_static"

# metric attributes the update wrapper or ``__setattr__`` keep, not the update body
_BOOKKEEPING = frozenset({"_state_fresh"})

# operations that read a device value on the host, size their output from data, or
# bring host data into the update: none of them can live in a fixed graph
_REFUSED = {
    "aten::_local_scalar_dense": "host-read",  # .item(), bool(), int(), float(), .tolist()
    "aten::is_nonzero": "host-read",
    "aten::equal": "host-read",
    "aten::nonzero": "data-sized-output",
    "aten::argwhere": "data-sized-output",
    "aten::_unique": "data-sized-output",
    "aten::_unique2": "data-sized-output",
    "aten::unique_dim": "data-sized-output",
    "aten::unique_consecutive": "data-sized-output",
    "aten::unique_dim_consecutive": "data-sized-output",
    "aten::masked_select": "data-sized-output",
    "aten::bincount": "data-sized-output",
    "aten::lift_fresh": "host-data",  # torch.tensor(...) / as_tensor(...) inside the update
    "aten::lift_fresh_copy": "host-data",
}
_BOOL_INDEXED = frozenset({"aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})


class _Ineligible(Exception):
    """Raised while building a signature to demote it to eager, with a recorded reason."""


class _Refused(_Ineligible):
    """``_Guard``'s refusal of an operation a captured graph cannot hold: a wrapper that
    runs an inner update as a pure body (``serve/window.extract_contribution``) lets it
    through to the engine, which demotes the step, where it turns its own
    ``_Ineligible`` (a side effect) into an error."""


# ------------------------------------------------------------------ diagnostics


def annotation_scope(owner: str, kind: str, key: Any) -> str:
    """The ``tm:<owner>:<kind>:<signature>`` name a replay is attributed to (the same
    signature digest as the cost ledger's entry), computed once per build."""
    return f"tm:{owner}:{kind}:{_costs.key_digest(key)}"


def signature_fingerprint(key: Tuple) -> Dict[str, Any]:
    """The aspects of a step signature a rebuild can be blamed on (argument layout and
    state names, dtypes, shapes, bucket, device), for ``diag.trace.attribute_retrace``."""
    bucket, n_args, kw_names, state_sig, in_sig = key[:5]
    names, dtypes, shapes, devices = [], [], [], set()
    for member, sig in state_sig:
        for k, shape, dtype, device in sig:
            names.append((member, k))
            shapes.append(shape)
            dtypes.append(str(dtype))
            devices.add(str(device))
    devices.update(str(d) for _, _, d in in_sig)
    return {
        "treedef": ((n_args, kw_names), tuple(names)),
        "dtype": (tuple(dtypes), tuple(str(d) for _, d, _ in in_sig)),
        "shape": (tuple(shapes), tuple(s for s, _, _ in in_sig)),
        "bucket": bucket,
        "device": tuple(sorted(devices)),
    }


def note_build(stats: EngineStats, kind: str, fingerprints: Dict[Tuple, Any], key: Tuple, fp: Dict[str, Any], **data: Any) -> str:
    """Attribute a new build against the engine's earlier ones: its cause (counted in
    ``retrace_causes`` past the first) and a ``<kind>.trace`` / ``<kind>.retrace``
    event."""
    cause = _diag.attribute_retrace(fp, list(fingerprints.values()))
    fingerprints[key] = fp
    if cause != "initial":
        stats.retrace_causes[cause] += 1
    _diag.record(f"{kind}.trace" if cause == "initial" else f"{kind}.retrace", stats.owner, cause=cause, **data)
    return cause


def probe_events(device: torch.device) -> Optional[Tuple[Any, Any]]:
    """A (start, end) pair of timing events for a sampled replay on a CUDA device."""
    if device.type != "cuda":
        return None
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def completion_probe(
    owner: str, kind: str, stats: EngineStats, t_dispatch: float, events: Optional[Tuple[Any, Any]]
) -> Tuple[float, Optional[float]]:
    """The sampled completion probe of one replay: wait on its end event inside
    ``transfer_allowed("profile-probe")``. Returns ``(device_us, device_event_us)``:
    dispatch start to results ready on the host clock (the JAX meaning), and the events'
    elapsed time (None on the CPU, where nothing runs asynchronously). The probe's
    overhead (``note_probe``) is the wait alone."""
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    t_block = perf_counter()
    event_us = None
    with transfer_allowed("profile-probe"):
        if events is not None:
            events[1].synchronize()
            event_us = round(events[0].elapsed_time(events[1]) * 1e3, 3)
    t_done = perf_counter()
    device_us = round((t_done - t_dispatch) * 1e6, 3)
    stats.profile_probes += 1
    _profile.note_probe(owner, kind, round((t_done - t_block) * 1e6, 3))
    _hist.observe(owner, kind, "device_us", device_us)
    if event_us is not None:
        _hist.observe(owner, kind, "device_event_us", event_us)
    return device_us, event_us


@contextmanager
def timed_replay(scope: str, device: torch.device, events: Optional[Tuple[Any, Any]]):
    """The attribution scope around one replay, with the probe's events recorded on the
    current stream when the replay is sampled."""
    with _profile.dispatch_scope(scope, device):
        if events is not None:
            events[0].record()
        yield
        if events is not None:
            events[1].record()


def _refusal(func: Any, args: tuple, kwargs: dict) -> Optional[str]:
    """Why ``func(*args, **kwargs)`` cannot run inside a captured graph, or None."""
    name = func._schema.name
    reason = _REFUSED.get(name)
    if reason is not None:
        return f"{reason}:{name[6:]}"
    if name == "aten::repeat_interleave" and kwargs.get("output_size") is None and func._overloadname != "self_int":
        return "data-sized-output:repeat_interleave"
    if name in _BOOL_INDEXED:
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8) for i in indices or ()):
            return f"data-sized-output:{name[6:]}(boolean mask)"
    if name in _COPIES:
        src = args[0] if name == "aten::_to_copy" else args[1]
        dst_device = kwargs.get("device") if name == "aten::_to_copy" else args[0].device
        if dst_device is not None and isinstance(src, torch.Tensor):
            kinds = {src.device.type, torch.device(dst_device).type}
            if len(kinds) > 1 and "cuda" in kinds:
                return "device-copy:" + "->".join((src.device.type, torch.device(dst_device).type))
    return None


class _Guard(TorchDispatchMode):
    """Raise ``_Ineligible`` on the first operation a captured graph cannot hold."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        reason = _refusal(func, args, kwargs)
        if reason is not None:
            raise _Refused(reason)
        return func(*args, **kwargs)


def _is_metric_like(x: Any) -> bool:
    # duck-typed: the engine stays import-acyclic with metric.py
    return hasattr(x, "_defaults") and hasattr(x, "update") and hasattr(x, "compute")


def holds_nested_metrics(metric: Any) -> bool:
    """True when ``metric`` owns inner metrics (wrappers, compositions).

    Running such an update as a graph would run the inner metrics' stateful host
    machinery once at capture and bake their state into the graph, which the
    per-attribute side-effect check cannot see (the inner object never changes
    identity). Wrappers therefore always run eagerly; their inner metrics' own engines
    still build the actual work. ``torch.nn.Module`` keeps submodules in ``_modules``,
    a dict, which the scan covers.

    A wrapper that runs its inner metric only as a pure body, through
    ``traced_update``'s snapshot/restore hygiene (the ``serve/`` streaming wrappers),
    names that attribute in ``_engine_traced_bodies`` and stays eligible. The exemption
    is per attribute: the named metric is skipped (as an attribute, and as the key
    ``torch.nn.Module`` files it under in ``_modules``); any other nested metric still
    disqualifies the wrapper.
    """
    exempt = getattr(metric, "_engine_traced_bodies", ())
    for k, v in metric.__dict__.items():
        if k in exempt:
            continue
        if k == "_modules" and isinstance(v, dict):
            v = {name: m for name, m in v.items() if name not in exempt}
        if _is_metric_like(v):
            return True
        if isinstance(v, (list, tuple)) and any(_is_metric_like(x) for x in v):
            return True
        if isinstance(v, dict) and any(_is_metric_like(x) for x in v.values()):
            return True
    return False


def _container_changed(live: Any, saved: Any) -> bool:
    """Shallow in-place change detection by length and element identity."""
    if len(live) != len(saved):
        return True
    if isinstance(live, list):
        return any(a is not b for a, b in zip(live, saved))
    if isinstance(live, dict):
        return live.keys() != saved.keys() or any(live[k] is not saved[k] for k in saved)
    return live != saved  # sets hold hashables only


_BODY = threading.local()


def in_traced_body() -> bool:
    """Whether this thread is inside an update body that ``traced_update`` runs: a
    signature's guarded first step, a capture, or a later step's body. A value check
    that reads the host skips there, as the JAX package's checks skip under a tracer
    (``TweedieDevianceScore``'s domain checks); run eagerly, it reads as before."""
    return getattr(_BODY, "depth", 0) > 0


@contextmanager
def _traced_body():
    _BODY.depth = getattr(_BODY, "depth", 0) + 1
    try:
        yield
    finally:
        _BODY.depth -= 1


def traced_update(
    metric: Any, state: Dict[str, Any], args: Sequence[Any], kwargs: Dict[str, Any], check: bool = True
) -> Dict[str, Any]:
    """Run ``metric``'s original update as ``state -> state``.

    With ``check`` (a signature's first step) the metric's ``__dict__`` is snapshotted
    and restored wholesale, so the step never leaves a buffer or a half-updated value
    on the live object, and an update with side effects a graph would lose (rebinding
    a non-state attribute, or growing or changing a mutable one in place,
    ``self.seen.append(...)``) raises ``_Ineligible``; an in-place change is rolled
    back, so the eager fallback does not repeat it. Later steps of a signature run as
    its graph does: the first step proved that the update writes only its states, so
    only those (and the freshness marker) are put back, and nothing else of the
    object is touched, which lets a background drain (``engine/async_dispatch.py``)
    run the body while the caller updates the metric's bookkeeping.
    """
    names = tuple(metric._defaults)
    if not check:
        saved = {k: metric.__dict__.get(k, _FALLBACK) for k in (*names, *_BOOKKEEPING)}
        try:
            for k in names:
                object.__setattr__(metric, k, state[k])
            with _traced_body():
                metric._raw_update(*args, **kwargs)
            return {k: getattr(metric, k) for k in names}
        finally:
            for k, v in saved.items():
                if v is _FALLBACK:
                    metric.__dict__.pop(k, None)
                else:
                    metric.__dict__[k] = v
    snapshot = dict(metric.__dict__)
    containers = {
        k: (list(v) if isinstance(v, list) else dict(v) if isinstance(v, dict) else set(v))
        for k, v in snapshot.items()
        if k not in names and isinstance(v, (list, dict, set))
    }
    try:
        for k in names:
            object.__setattr__(metric, k, state[k])
        with _traced_body():
            metric._raw_update(*args, **kwargs)
        out = {k: getattr(metric, k) for k in names}
        for k, v in metric.__dict__.items():
            if k in names or k in _BOOKKEEPING:
                continue
            if snapshot.get(k, _FALLBACK) is not v:
                raise _Ineligible(f"update writes non-state attribute {k!r}")
            if k in containers and _container_changed(v, containers[k]):
                raise _Ineligible(f"update mutates non-state container {k!r} in place")
        return out
    finally:
        metric.__dict__.clear()
        metric.__dict__.update(snapshot)
        for k, saved_container in containers.items():
            live = snapshot[k]
            if _container_changed(live, saved_container):
                if isinstance(live, list):
                    live[:] = saved_container
                else:
                    live.clear()
                    live.update(saved_container)


def is_static(x: Any) -> bool:
    """Whether ``x`` is (or a placed state wraps) an engine's static state buffer,
    written in place by replays."""
    return isinstance(x, torch.Tensor) and getattr(_sharding.local(x), STATIC_MARK, False)


def _storage(x: torch.Tensor) -> int:
    return _sharding.local(x).untyped_storage().data_ptr()


def detach_from_static(value: Any, states: Sequence[Any]) -> Any:
    """``value`` with every tensor that shares storage with one of ``states``' static
    buffers replaced by a copy: a value handed out must not change under the next
    replay."""
    live = {_storage(s) for s in states if is_static(s)}
    if not live:
        return value
    return apply_to_collection(value, torch.Tensor, lambda t: t.clone() if _storage(t) in live else t)


def protected_ids(metric: Any) -> set:
    """Storage addresses of tensors that outlive the state slot: the registered
    defaults that ``reset`` restores, the ``sync`` snapshot ``_cache``, a cached
    ``compute`` value and the last ``forward`` value."""
    ids = {_storage(v) for v in metric._defaults.values() if isinstance(v, torch.Tensor)}
    for holder in (metric._cache, metric._computed, metric._forward_cache):
        if holder is not None:
            apply_to_collection(holder, torch.Tensor, lambda t: ids.add(_storage(t)))
    return ids


def shield_state(metric: Any, buffers: Dict[str, torch.Tensor], stats: EngineStats) -> None:
    """Give every protected holder that shares storage with a static buffer its own
    copy before a replay writes the buffers in place (counted in ``donation_copies``)."""
    live = {_storage(b) for b in buffers.values()}
    if not live & protected_ids(metric):
        return

    def copy(t: torch.Tensor) -> torch.Tensor:
        if _storage(t) not in live:
            return t
        stats.donation_copies += 1
        return t.clone()

    for k, v in metric._defaults.items():
        if isinstance(v, torch.Tensor):
            metric._defaults[k] = copy(v)
    for holder in ("_cache", "_computed", "_forward_cache"):
        value = metric.__dict__.get(holder)
        if value is not None:
            metric.__dict__[holder] = apply_to_collection(value, torch.Tensor, copy)


def state_signature(state: Dict[str, torch.Tensor]) -> Tuple:
    """Shape / dtype / device key over a state dict."""
    return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in state.items())


def input_signature(inputs: Sequence[Any]) -> Optional[Tuple]:
    """Shape / dtype / device key for the inputs, or None when one is not a tensor."""
    sig = []
    for a in inputs:
        if not isinstance(a, torch.Tensor):
            return None
        sig.append((tuple(a.shape), a.dtype, a.device))
    return tuple(sig)


def needs_grad(inputs: Sequence[torch.Tensor]) -> bool:
    """Whether an input records a gradient: such an update keeps the eager path's
    autograd semantics (a graph replay records none)."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in inputs)


def static_state_buffers(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh static state buffers shaped like ``state``, marked ``STATIC_MARK``."""
    bufs = {}
    for k, v in state.items():
        buf = torch.zeros_like(v, memory_format=torch.contiguous_format)
        setattr(buf, STATIC_MARK, True)
        bufs[k] = buf
    return bufs


class StaticInputs:
    """One signature's static input buffers and the copy of a batch into them.

    Batched inputs (``ndim >= 1``) get ``bucket`` rows when bucketed; the rows past the
    batch stay zero (the pad rows). ``rows`` remembers how many leading rows hold data,
    so a later, shorter batch zeroes only what the longer one left behind.
    """

    __slots__ = ("buffers", "bucket", "rows", "n_pad", "pad_value")

    def __init__(self, inputs: Sequence[torch.Tensor], bucket: Optional[int]) -> None:
        self.bucket = bucket
        self.buffers: List[torch.Tensor] = [
            torch.zeros(bucketing.bucketed_shape(a, bucket) if bucket else a.shape, dtype=a.dtype, device=a.device)
            for a in inputs
        ]
        self.rows = 0
        # the pad-row count the graph reads; -1: not written yet
        self.n_pad = torch.zeros((), dtype=torch.int32, device=inputs[0].device) if bucket else None
        self.pad_value = -1

    def fill(self, inputs: Sequence[torch.Tensor], stats: EngineStats) -> None:
        """Copy a batch in: the data rows, a zero tail where needed, the pad count."""
        with torch.no_grad():
            if self.bucket is None:
                for dst, src in zip(self.buffers, inputs):
                    dst.copy_(src)
                    stats.input_copy_bytes += src.nbytes
                return
            n = bucketing.batch_size(inputs)
            for dst, src in zip(self.buffers, inputs):
                if src.ndim == 0:
                    dst.copy_(src)
                else:
                    dst[:n].copy_(src)
                    if n < self.rows:
                        dst[n : self.rows].zero_()
                stats.input_copy_bytes += src.nbytes
            self.rows = n
            n_pad = self.bucket - n
            if n_pad != self.pad_value:
                self.n_pad.fill_(n_pad)
                self.pad_value = n_pad


def pad_subtract_into(
    out: Dict[str, torch.Tensor],
    unit: Optional[Dict[str, torch.Tensor]],
    n_pad: Optional[torch.Tensor],
    buffers: Dict[str, torch.Tensor],
) -> None:
    """Write ``out - n_pad * unit`` (or ``out`` when not bucketed) into ``buffers``,
    one operation per state: the step's write when it carries no rider."""
    for k, buf in buffers.items():
        if unit is not None:
            torch.addcmul(out[k], unit[k], n_pad, value=-1, out=buf)
        elif out[k] is not buf:
            buf.copy_(out[k])


def check_fixed_point(name: str, out: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor]) -> None:
    """A graph writes each state back into its buffer: an update that changes a
    state's shape, dtype or kind builds no graph (the next signature may)."""
    for k, v in out.items():
        buf = buffers[k]
        if not isinstance(v, torch.Tensor) or v.shape != buf.shape or v.dtype != buf.dtype or v.device != buf.device:
            raise _Ineligible(f"{name} changes state {k!r} to {type(v).__name__} {getattr(v, 'dtype', '')}")


def under_capture(device: torch.device) -> bool:
    """Whether the caller is itself capturing a CUDA graph on ``device``: its capture
    records the eager update, as the JAX engine leaves an update under someone else's
    trace to the eager path."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def capture(body, pool: Any, device: torch.device) -> Tuple[Any, Dict[str, int]]:
    """Capture ``body()`` into a ``torch.cuda.CUDAGraph`` on ``pool``, on ``device``.

    Returns the graph and the kernel launches it holds. The wrappers count a launch
    when they are called; under capture they record instead of launching, so their
    counts are put back and each replay adds the recorded ones. An error inside the
    capture ends it, releases the graph's memory and propagates, the body's own error
    first: the ladder (``engine/txn.py``) classifies an out-of-memory error and retries
    the batch smaller; any other capture error is a fault. The caller drops its pool
    after a failed capture (a capture that could not end leaves its pool recording).

    The garbage collector is off during the capture: it could free another engine's
    graph (an engine and its metric hold each other), and destroying a graph is not
    permitted while a stream captures. A capture that cannot end (an operation the
    graph could not hold invalidated it) skips ``torch.cuda.graph``'s return to the
    caller's stream, so that stream is set back here.
    """
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    err: Optional[BaseException] = None
    collecting = gc.isenabled()
    caller_stream = torch.cuda.current_stream(device)
    gc.disable()  # torch.cuda.graph collects once on entry
    try:
        with torch.cuda.device(device), torch.no_grad():
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                try:
                    body()
                except BaseException as exc:  # noqa: BLE001 -- re-raised below, after the capture ends
                    err = exc
    except BaseException:
        torch.cuda.set_stream(caller_stream)
        if err is None:
            ops.set_launch_counts(before)
            raise
    finally:
        if collecting:
            gc.enable()
    held = {k: v - before[k] for k, v in ops.launch_counts().items()}
    ops.set_launch_counts(before)
    if err is not None:
        try:
            graph.reset()
        except Exception:  # noqa: BLE001 -- the graph is dropped either way
            pass
        raise err
    return graph, held


def measured_capture(body, pool: Any, device: torch.device) -> Tuple[Tuple[Any, Dict[str, int]], float, int]:
    """``capture`` with the cost ledger's figures: ``((graph, launches), capture ms, the
    growth of the CUDA allocator's reserved bytes around it)``."""
    reserved = torch.cuda.memory_reserved(device)
    t0 = perf_counter()
    captured = capture(body, pool, device)
    return captured, (perf_counter() - t0) * 1e3, max(0, torch.cuda.memory_reserved(device) - reserved)


def structural_refusal(metric: Any) -> Optional[str]:
    """Why ``metric`` can never run as a graph (no state, a list state, inner
    metrics), or None."""
    defaults = metric._defaults
    if not defaults:
        return "stateless"
    if any(isinstance(d, list) for d in defaults.values()):
        return "list-state"
    if holds_nested_metrics(metric):
        return "nested-metric"
    return None


# ------------------------------------------------------------------ riders


def gather_riders(metric: Any) -> Dict[str, torch.Tensor]:
    """The rider tensors that join ``metric``'s step state under the active policy: the
    health sentinel (``diag/sentinel.py``), the quarantine counter (``engine/txn.py``)
    and the compensation residuals (``engine/numerics.py``), each under its reserved
    key. Created at first use."""
    from torchmetrics_tpu_torch.engine import numerics, txn

    riders: Dict[str, torch.Tensor] = {}
    if _sentinel.sentinel_enabled():
        riders[_sentinel.STATE_KEY] = _sentinel.ensure_flags(metric)
    if txn.quarantine_enabled():
        riders[txn.STATE_KEY] = txn.ensure_count(metric)
    if numerics.compensation_active(metric):
        for k, r in numerics.ensure_residuals(metric).items():
            riders[numerics.residual_key(k)] = r
    return riders


def step_state(metric: Any) -> Dict[str, torch.Tensor]:
    """The registered states and the active riders: what one step reads and writes. A
    sharded state is its local block (``parallel/sharding.py``): the step runs on it."""
    state = {k: _sharding.local(getattr(metric, k)) for k in metric._defaults}
    state.update(gather_riders(metric))
    return state


def bind_buffers(metric: Any, state: Dict[str, Any], buffers: Dict[str, torch.Tensor]) -> None:
    """Make ``metric``'s states and riders its static buffers (where they are not
    already): the next replay updates them in place."""
    from torchmetrics_tpu_torch.engine import numerics, txn

    residuals = None
    for k, buf in buffers.items():
        if state.get(k) is buf:
            continue
        if k == txn.STATE_KEY:
            metric.__dict__[txn.ATTR] = buf
        elif k == _sentinel.STATE_KEY:
            metric.__dict__[_sentinel.ATTR] = buf
        elif k.startswith(numerics.STATE_KEY):
            if residuals is None:
                residuals = dict(metric.__dict__.get(numerics.ATTR) or {})
            residuals[k[len(numerics.STATE_KEY) :]] = buf
        else:
            setattr(metric, k, _sharding.wrap_like(metric, k, buf))
    if residuals is not None:
        metric.__dict__[numerics.ATTR] = residuals


class MemberPlan:
    """One metric's part of a built signature: its static state buffers (riders
    included), its constant pad-row unit (None when a 0-d input feeds it or the step is
    not bucketed), and its riders: the compensated states, the admission check and the
    sentinel fold."""

    __slots__ = ("name", "metric", "buffers", "unit", "comp_names", "comp", "admission", "sentinel")

    def __init__(self, name: str, metric: Any, buffers: Dict[str, torch.Tensor], inputs: Sequence[torch.Tensor]) -> None:
        from torchmetrics_tpu_torch.engine import numerics, txn

        self.name = name
        self.metric = metric
        self.buffers = buffers
        self.unit: Optional[Dict[str, torch.Tensor]] = None
        self.comp_names = tuple(k for k in numerics.comp_state_names(metric) if numerics.residual_key(k) in buffers)
        self.comp = numerics.build_compensation(self.comp_names) if self.comp_names else None
        self.admission = txn.build_admission(metric, inputs) if txn.STATE_KEY in buffers else None
        self.sentinel = _sentinel.STATE_KEY in buffers

    @property
    def riders(self) -> bool:
        return self.comp is not None or self.admission is not None or self.sentinel


def member_update(
    plan: MemberPlan,
    state: Dict[str, torch.Tensor],
    flat: Sequence[torch.Tensor],
    n_args: int,
    kw_names: Tuple[str, ...],
    bucketed: bool,
    guard: bool,
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """The update body of one member on ``state`` and the inputs ``flat``: ``(out,
    unit)``, ``out`` the registered states after the update (the compensated ones as
    the batch's pure contribution: the body runs on zeroed copies of them) and ``unit``
    the pad rows' contribution when bucketed (the plan's constant, or computed here
    when a 0-d input feeds it). ``guard``: the first step of a signature."""
    m = plan.metric
    update_in = {k: torch.zeros_like(state[k]) if k in plan.comp_names else state[k] for k in m._defaults}
    unit = plan.unit
    with torch.no_grad(), (_Guard() if guard else nullcontext()):
        out = traced_update(m, update_in, flat[:n_args], dict(zip(kw_names, flat[n_args:])), check=guard)
        if bucketed and unit is None:
            rows = bucketing.pad_row_constants(flat)
            unit_flat = [r if r is not None else b for r, b in zip(rows, flat)]
            zeros = {k: torch.zeros_like(v) for k, v in update_in.items()}
            unit = traced_update(m, zeros, unit_flat[:n_args], dict(zip(kw_names, unit_flat[n_args:])), check=guard)
    return out, unit


def write_step(
    plan: MemberPlan,
    state: Dict[str, torch.Tensor],
    out: Dict[str, torch.Tensor],
    unit: Optional[Dict[str, torch.Tensor]],
    n_pad: Optional[torch.Tensor],
    flat: Sequence[torch.Tensor],
    valid: Optional[torch.Tensor] = None,
    buffers: Optional[Dict[str, torch.Tensor]] = None,
) -> None:
    """Finish one member's step into its buffers (or into ``buffers``), in JAX ``make_step_body``'s order:
    pad-subtract, then the compensated two-sum, then the quarantine transaction, then the
    sentinel's fold over the final states (``input_poisoned`` where the batch was
    quarantined, ``precision_loss`` where an admitted contribution was absorbed); a scan
    step (``valid`` given) then keeps the carry where the step is a pad step.

    ``state`` holds the pre-step values (the buffers themselves after a signature's
    first step): each candidate is computed in full before any buffer is written, so
    the transaction and the mask select against intact old values. Without riders or a
    mask the write is one operation per state (``pad_subtract_into``).
    """
    buffers = plan.buffers if buffers is None else buffers
    with torch.no_grad():
        if valid is None and not plan.riders:
            pad_subtract_into(out, unit, n_pad, buffers)
            return
        cand = {k: torch.addcmul(v, unit[k], n_pad, value=-1) if unit is not None else v for k, v in out.items()}
        absorbed = poisoned = None
        if plan.comp is not None:
            cand, absorbed = plan.comp(state, cand)
        if plan.admission is not None:
            from torchmetrics_tpu_torch.engine import txn

            poisoned = plan.admission(flat)
            cand = txn.transact(state, cand, poisoned)
        if plan.sentinel:
            m = plan.metric
            flags = _sentinel.update_flags(state[_sentinel.STATE_KEY], {k: cand[k] for k in m._defaults}, m)
            if absorbed is not None:
                lost = absorbed & ~poisoned if poisoned is not None else absorbed
                flags = flags | lost.to(torch.int32) * _sentinel.FLAG_PRECISION_LOSS
            if poisoned is not None:
                flags = flags | poisoned.to(torch.int32) * _sentinel.FLAG_INPUT_POISONED
            cand[_sentinel.STATE_KEY] = flags
        for k, buf in buffers.items():
            if valid is not None:
                torch.where(valid, cand[k], buf, out=buf)  # one operation: the select writes the buffer
            elif cand[k] is not buf:
                buf.copy_(cand[k])


def run_members(
    plans: Sequence[MemberPlan],
    flat: Sequence[torch.Tensor],
    n_pad: Optional[torch.Tensor],
    n_args: int,
    kw_names: Tuple[str, ...],
    bucketed: bool,
    valid: Optional[torch.Tensor] = None,
) -> None:
    """One step of every member on its static buffers: the body a one-step graph and
    each step of a scan graph (``engine/scan.py``) hold."""
    for plan in plans:
        out, unit = member_update(plan, plan.buffers, flat, n_args, kw_names, bucketed, guard=False)
        write_step(plan, plan.buffers, out, unit, n_pad, flat, valid)


class _Entry:
    """One built signature: its static inputs, its members' plans and, on the card,
    its graph and the kernel launches the graph holds."""

    __slots__ = ("inputs", "plans", "n_args", "kw_names", "graph", "launches", "scope", "step_bytes")

    def __init__(self, inputs: StaticInputs, plans: List[MemberPlan], n_args: int, kw_names: Tuple[str, ...]) -> None:
        self.inputs = inputs
        self.plans = plans
        self.n_args = n_args
        self.kw_names = kw_names
        self.graph: Any = None
        self.launches: Dict[str, int] = {}
        self.scope = ""  # the tm:<owner>:<kind>:<signature> attribution scope
        # bytes a step reads: its static inputs and every member's state buffers
        self.step_bytes = sum(b.nbytes for b in inputs.buffers) + sum(
            b.nbytes for p in plans for b in p.buffers.values()
        )

    @property
    def members(self) -> List[Tuple[str, Any]]:
        return [(p.name, p.metric) for p in self.plans]

    def run(self) -> None:
        """The step body: every member's update on its static buffers and the static
        inputs, the pad-subtract identity and the riders, the write into the buffers."""
        run_members(
            self.plans, self.inputs.buffers, self.inputs.n_pad, self.n_args, self.kw_names, self.inputs.bucket is not None
        )


class _BuildFailed(Exception):
    """A classified failure (out of memory) while building a signature."""

    def __init__(self, exc: BaseException) -> None:
        super().__init__(str(exc))
        self.exc = exc


class GraphEngine:
    """Captured update graphs over the states of one or more metrics fed by one batch.

    ``run`` is one step; a subclass picks the members and counts what its first step
    leaves out (``_count_refusals``). A signature keeps at least ``min_members``.
    ``_scan`` is the engine's K-step queue (``engine/scan.py``), made at its first
    queued step.
    """

    min_members = 1
    #: the event and histogram kind of a step (``update.*``; ``fused.*`` for a collection)
    kind = "update"
    #: the placement part of a cache key (``parallel/sharding.placement_token``)
    _device_token = staticmethod(_sharding.placement_token)

    def __init__(self, owner: str) -> None:
        self._cache: Dict[Tuple, Any] = {}
        self._fingerprints: Dict[Tuple, Dict[str, Any]] = {}  # built keys, for retrace attribution
        self._buffers: Dict[Tuple, Dict[str, torch.Tensor]] = {}  # (member, state signature) -> static buffers
        self._pool: Any = None  # this engine's CUDA graph memory pool, made at the first capture
        self._bucket_ok: Dict[str, bool] = {}  # per member, frozen on first sight
        self._transient_fails: Dict[Tuple, int] = {}  # key -> classified build failures (ladder budget)
        self._scan: Any = None
        self.stats = EngineStats(owner)

    def run(
        self, members: List[Tuple[str, Any]], args: Tuple[Any, ...], kwargs: Dict[str, Any]
    ) -> Optional[List[Tuple[str, Any]]]:
        """One step over ``members`` (each holding tensor states) through the signature's
        graph (its plain step on the CPU): the members whose states it wrote, or None
        when the whole step falls back (counted). Never raises for eligibility reasons;
        raises when an eligible signature fails to capture for a reason that is not
        classified, or a built one fails to run.
        """
        st = self.stats
        owner = st.owner
        with _diag.span("engine.key", owner):
            kw_names = tuple(sorted(kwargs))
            inputs = [*args, *(kwargs[k] for k in kw_names)]
            in_sig = self._eligible_inputs(members, inputs)
            if in_sig is not None:
                states = {name: step_state(m) for name, m in members}
                bucket = self._bucket(members, inputs)
                if bucket is not None:
                    in_sig = tuple((bucketing.bucketed_shape(a, bucket), a.dtype, a.device) for a in inputs)
                state_sig = tuple((name, state_signature(states[name])) for name, _ in members)
                # the placement joins the key: a re-placed state builds a fresh graph
                placement = tuple(_sharding.metric_placement_token(m) for _, m in members)
                key = (bucket, len(args), kw_names, state_sig, in_sig, placement)
                entry = self._cache.get(key)
        if in_sig is None:
            return None
        if entry is _FALLBACK:
            st.fallback("uncompilable-signature")
            return None
        first = entry is None
        profiling = _profile.active_profile() is not None
        device_us = event_us = None
        if first:
            with _diag.span("engine.build", owner) as work:
                try:
                    entry = self._build(key, members, states, inputs)
                except _BuildFailed as failed:
                    from torchmetrics_tpu_torch.engine import txn

                    applied = isinstance(failed.exc, _Applied)
                    exc = failed.exc.exc if applied else failed.exc
                    classified = txn.classify_and_demote(self._cache, _FALLBACK, self._transient_fails, key, exc)
                    if applied:
                        # the warm-up wrote this step; only the graph is missing (retried
                        # at the signature's next step, within the budget)
                        st.fallback_reasons[f"capture-{classified}"] += 1
                        st.dispatches += 1
                        st.metrics_updated += len(members)
                        return members
                    return self._on_build_failure(members, args, kwargs, bucket, classified)
            if entry is None:
                return None
        else:
            with _diag.span("engine.stage", owner):
                for plan in entry.plans:
                    shield_state(plan.metric, plan.buffers, st)
                    copy_into_buffers(states[plan.name], plan.buffers, st)
                entry.inputs.fill(inputs, st)
            device = members[0][1].device
            probing = profiling and _profile.probe_due(st.owner, self.kind)
            events = probe_events(device) if probing else None
            with _diag.span("engine.replay", owner) as work:
                if work is not None:
                    work.attrs = {"scope": entry.scope}
                with timed_replay(entry.scope, device, events):
                    if entry.graph is not None:
                        entry.graph.replay()
                        ops.add_launches(entry.launches)
                        st.replays += 1
                    elif device.type == "cuda":
                        raise RuntimeError("a CUDA engine step has no captured graph")
                    else:
                        entry.run()
            if probing:
                t_dispatch = work.t0 * 1e-9 if work is not None else perf_counter()
                device_us, event_us = completion_probe(st.owner, self.kind, st, t_dispatch, events)
        st.traces += first
        st.cache_hits += not first
        st.dispatches += 1
        st.metrics_updated += len(entry.plans)
        with _diag.span("engine.bind", owner) as bind:
            for plan in entry.plans:
                bind_buffers(plan.metric, states[plan.name], plan.buffers)
            self._count_riders(entry.plans, 1)
        if first:
            note_build(
                st, self.kind, self._fingerprints, key, signature_fingerprint(key),
                bucket=bucket, members=len(entry.plans),
            )
        if work is not None:
            # the build or the replay, through the binding of its states
            dispatch_us = _diag.observe_dispatch(
                work, st.owner, self.kind, f"{self.kind}.dispatch", end=bind, bucketed=bucket is not None,
                pad_rows=entry.inputs.bucket - entry.inputs.rows if bucket is not None else 0,
                bytes=entry.step_bytes, members=len(entry.plans), cached=not first,
            )
            rec = _diag.active_recorder()
            if rec is not None and dispatch_us is not None and device_us is not None:
                probe = {"device_event_us": event_us} if event_us is not None else {}
                rec.record(f"{self.kind}.probe", st.owner, dispatch_us=dispatch_us, device_us=device_us, **probe)
        if profiling and not first:
            from torchmetrics_tpu_torch.engine import numerics

            for plan in entry.plans:
                if plan.comp is not None:
                    # the sampled drift audit, each member on its own cadence
                    numerics.maybe_drift_probe(plan.metric, st, owner=f"{st.owner}:{plan.name}" if plan.name else None)
        return entry.members

    def _eligible_inputs(self, members: List[Tuple[str, Any]], inputs: List[Any]) -> Optional[Tuple]:
        """The inputs' signature, or None (counted) when the step cannot run as a graph:
        a non-tensor input, an input that records a gradient, a caller's capture."""
        st = self.stats
        in_sig = input_signature(inputs)
        if in_sig is None:
            st.fallback("non-tensor-input")
            return None
        if needs_grad(inputs):
            st.fallback("grad-input")
            return None
        if under_capture(members[0][1].device):
            st.fallback("under-capture")
            return None
        return in_sig

    def _count_riders(self, plans: Sequence[MemberPlan], steps: int) -> None:
        self.stats.compensated_steps += steps * sum(1 for p in plans if p.comp is not None)

    def _on_build_failure(
        self, members: List[Tuple[str, Any]], args: Tuple[Any, ...], kwargs: Dict[str, Any], bucket: Optional[int], classified: str
    ) -> Optional[List[Tuple[str, Any]]]:
        """A classified failure building a signature: this step falls back (counted)."""
        self.stats.fallback(f"dispatch-{classified}")
        return None

    def _count_refusals(self, refused: List[Tuple[str, str]], demoted: bool) -> None:
        """Count the members a signature's first step left out, as ``(name, reason)``;
        ``demoted``: too few members were left to build it. One metric: its reason is
        the step's fallback reason."""
        for _, reason in refused:
            self.stats.fallback(reason)

    # ------------------------------------------------------------------ internals

    def _bucket(self, members: List[Tuple[str, Any]], inputs: List[torch.Tensor]) -> Optional[int]:
        """The shape bucket of this batch when every member supports the pad-subtract
        identity for it (``engine/bucketing.py``), else None (an exact-shape graph)."""
        if not config.BUCKETING_ENABLED:
            return None
        for name, m in members:
            ok = self._bucket_ok.get(name)
            if ok is None:
                ok = self._bucket_ok[name] = bucketing.bucket_eligible(m)
            if not ok or not bucketing.pad_rows_neutral(m, inputs):
                return None
        n = bucketing.batch_size(inputs)
        if n is None or n == 0:
            return None
        bucket = bucketing.next_bucket(n)
        if bucket == n and any(a.ndim == 0 for a in inputs):
            # a full bucket has nothing to subtract, and a unit fed by a 0-d input is not
            # constant: its graph would rerun the update on a pad row at every replay
            return None
        self.stats.bucketed_steps += 1
        self.stats.bucket_pad_rows += bucket - n
        self.stats.bucket_sizes.add(bucket)
        return bucket

    def _state_buffers(self, name: str, m: Any, sig: Tuple, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The member's static state buffers for ``sig``, shielded from other holders
        when another signature already wrote them."""
        bufs = self._buffers.get((name, sig))
        if bufs is None:
            bufs = self._buffers[(name, sig)] = static_state_buffers(state)
        else:
            shield_state(m, bufs, self.stats)
        return bufs

    def prepare(
        self,
        members: List[Tuple[str, Any]],
        state_sigs: Sequence[Tuple],
        states: Dict[str, Dict[str, torch.Tensor]],
        flat: Sequence[torch.Tensor],
        n_pad: Optional[torch.Tensor],
        bucketed: bool,
        n_args: int,
        kw_names: Tuple[str, ...],
    ) -> Tuple[List[MemberPlan], List[Tuple[str, str]], Dict[str, Dict[str, torch.Tensor]]]:
        """The guarded first step of a signature on the static inputs ``flat``: each
        member's plan, its constant pad-row unit, and its update under ``_Guard`` on
        copies of its state (so a refusal midway leaves it intact). Returns the plans
        that passed, the refusals as ``(name, reason)`` and each passing member's step
        result (every state and rider), not yet written. That run is also the warm-up
        a capture needs. A classified failure (out of memory) raises ``_BuildFailed``.
        """
        plans: List[MemberPlan] = []
        refused: List[Tuple[str, str]] = []
        results: Dict[str, Dict[str, torch.Tensor]] = {}
        batched = all(a.ndim >= 1 for a in flat)
        for (name, m), sig in zip(members, state_sigs):
            try:
                plan = MemberPlan(name, m, self._state_buffers(name, m, sig, states[name]), flat)
                if bucketed and batched:
                    plan.unit = constant_unit(m, states[name], flat, n_args, kw_names, plan.buffers)
                clones = {k: v.clone() for k, v in states[name].items()}
                out, unit = member_update(plan, clones, flat, n_args, kw_names, bucketed, guard=True)
                check_fixed_point("update", out, plan.buffers)
                # staged: the live state may be this signature's buffer, and a member
                # must not move before the signature is known to build
                staged = {k: torch.empty_like(b) for k, b in plan.buffers.items()}
                write_step(plan, clones, out, unit, n_pad, flat, buffers=staged)
            except Exception as exc:  # noqa: BLE001 -- a failed first step leaves its member out
                from torchmetrics_tpu_torch.engine import txn

                if txn.classify_dispatch_error(exc) is not None:
                    raise _BuildFailed(exc) from exc
                refused.append((name, str(exc) if isinstance(exc, _Ineligible) else f"trace-failed:{type(exc).__name__}"))
                continue
            plans.append(plan)
            results[name] = staged
        return plans, refused, results

    def _build(
        self,
        key: Tuple,
        members: List[Tuple[str, Any]],
        states: Dict[str, Dict[str, torch.Tensor]],
        inputs: List[torch.Tensor],
    ) -> Optional[_Entry]:
        """First step of a signature: the guarded warm-up (``prepare``), which is this
        step's update, written into the survivors' buffers; then, on a CUDA device, the
        capture. None, with the signature demoted, when fewer than ``min_members`` pass.
        A classified failure (allocating the static inputs, in the warm-up or in the
        capture) raises ``_BuildFailed``."""
        from torchmetrics_tpu_torch.engine import txn

        st = self.stats
        bucket, n_args, kw_names = key[:3]
        device = members[0][1].device
        _persist.lookup_executable(st, st.owner, self.kind, _costs.key_digest(key), device)
        t_build = perf_counter()
        try:
            static = StaticInputs(inputs, bucket)
        except Exception as exc:  # noqa: BLE001 -- classified below
            if txn.classify_dispatch_error(exc) is None:
                raise
            raise _BuildFailed(exc) from exc
        static.fill(inputs, st)
        plans, refused, results = self.prepare(
            members, [sig for _, sig in key[3]], states, static.buffers, static.n_pad, bucket is not None, n_args, kw_names
        )
        demoted = len(plans) < self.min_members
        self._count_refusals(refused, demoted)
        if demoted:
            self._cache[key] = _FALLBACK
            return None
        with torch.no_grad():
            for plan in plans:
                for k, buf in plan.buffers.items():
                    buf.copy_(results[plan.name][k])
        entry = _Entry(static, plans, n_args, kw_names)
        entry.scope = annotation_scope(st.owner, self.kind, key)
        capture_ms = pool_bytes = None
        if device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            try:
                (entry.graph, entry.launches), capture_ms, pool_bytes = measured_capture(entry.run, self._pool, device)
            except Exception as exc:  # noqa: BLE001 -- classified below; the step's result is written
                self._pool = None
                if txn.classify_dispatch_error(exc) is None:
                    raise
                # the warm-up already wrote this step: the ladder must not apply it again
                for plan in plans:
                    bind_buffers(plan.metric, states[plan.name], plan.buffers)
                raise _BuildFailed(_Applied(exc)) from exc
            st.captures += 1
        _costs.record_build(
            st.owner, self.kind, _costs.key_digest(key), (perf_counter() - t_build) * 1e3,
            inputs=static.buffers, states=[b for plan in plans for b in plan.buffers.values()],
            capture_ms=capture_ms, pool_bytes=pool_bytes,
        )
        # the caller's inputs: a zero replay of their shapes lands in this bucket again
        _persist.record_compile(
            st.owner, self.kind, args=inputs[:n_args], kw=dict(zip(kw_names, inputs[n_args:])), bucket=bucket
        )
        self._cache[key] = entry
        return entry


class _Applied(Exception):
    """A classified capture failure after the warm-up step already applied the batch."""

    def __init__(self, exc: BaseException) -> None:
        super().__init__(f"{type(exc).__name__}: {exc}")
        self.exc = exc


def constant_unit(
    metric: Any,
    state: Dict[str, torch.Tensor],
    inputs: Sequence[torch.Tensor],
    n_args: int,
    kw_names: Tuple[str, ...],
    buffers: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The pad rows' contribution ``update(zeros, one_pad_row)`` when every input is
    batched: it then depends on nothing that changes, so it is computed once, at the
    signature's first step (guarded), and kept."""
    zeros = {k: torch.zeros_like(state[k]) for k in metric._defaults}
    rows = bucketing.pad_row_constants(inputs)
    with torch.no_grad(), _Guard():
        unit = traced_update(metric, zeros, rows[:n_args], dict(zip(kw_names, rows[n_args:])))
    check_fixed_point("the pad-row update", unit, buffers)
    return unit


class CompiledUpdate(GraphEngine):
    """Compiled-step cache for ONE metric instance.

    Made at the metric's first engine-enabled update (``Metric._engine_step``); never
    pickled or cloned (graphs and buffers belong to the instance).
    """

    def __init__(self, metric: Any) -> None:
        super().__init__(type(metric).__name__)
        self._metric = metric
        self._disabled_reason = structural_refusal(metric)

    def step(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> bool:
        """Run one update through the engine; False requests the eager fallback."""
        m = self._metric
        if self._disabled_reason is not None:
            self.stats.fallback(self._disabled_reason)
            return False
        if not all(isinstance(getattr(m, k), torch.Tensor) for k in m._defaults):
            self.stats.fallback("non-tensor-state")
            return False
        return self.run([("", m)], args, kwargs) is not None

    def scan_step(self, args: Tuple[Any, ...], kwargs: Dict[str, Any], k: int, async_inflight: Optional[int] = None) -> bool:
        """Queue one update for the K-step scan drain (``engine/scan.py``); False
        requests the eager fallback for this step, after the queue drained."""
        if self._disabled_reason is not None:
            self.stats.fallback(self._disabled_reason)
            return False
        if self._scan is None:
            from torchmetrics_tpu_torch.engine.scan import MetricScan

            self._scan = MetricScan(self)
        return self._scan.push(args, kwargs, k, async_inflight)

    def _on_build_failure(self, members, args, kwargs, bucket, classified):
        if bucket is not None and classified is not None and self._ladder_step(args, kwargs, bucket, classified):
            return members
        st = self.stats
        st.fallback(f"dispatch-{classified}")
        return None

    def _ladder_step(self, args: Tuple[Any, ...], kwargs: Dict[str, Any], bucket: int, classified: str) -> bool:
        """Fallback-ladder rung 2: retry the batch as half-bucket chunks.

        A classified failure building bucket ``b`` re-enters the same machinery with the
        batch split at ``b/2``, exact for the row-additive metrics bucketing admits.
        The first chunk failing leaves the state untouched (False: the caller's eager
        rung takes the whole batch); a second chunk failing after the first applied runs
        eagerly here, with quarantine parity. Under quarantine the whole batch is
        admitted once (one host read) before chunking, so a poisoned batch is skipped
        whole and counted once.
        """
        from torchmetrics_tpu_torch.engine import txn

        half = bucket // 2
        if half < config.MIN_BUCKET:
            return False
        kw_names = tuple(sorted(kwargs))
        flat = list(args) + [kwargs[k] for k in kw_names]
        n = bucketing.batch_size(flat)
        if n is None or n <= half:
            return False
        st = self.stats
        m = self._metric
        if txn.quarantine_enabled():
            from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

            poisoned = txn.build_admission(m, flat)(flat)
            with transfer_allowed("quarantine-check"):
                bad = bool(poisoned)
            if bad:
                m.__dict__[txn.ATTR] = txn.ensure_count(m) + 1
                if _sentinel.sentinel_enabled():
                    m.__dict__[_sentinel.ATTR] = _sentinel.ensure_flags(m) | _sentinel.FLAG_INPUT_POISONED
                _diag.record(
                    "update.ladder", st.owner, from_bucket=bucket, to_bucket=half, error=classified, rows=n, quarantined=True
                )
                return True
        # the event narrates the attempted walk; the counter counts a step-down that applied
        _diag.record("update.ladder", st.owner, from_bucket=bucket, to_bucket=half, error=classified, rows=n)

        def chunk(lo: int, hi: int) -> Tuple[Tuple[Any, ...], Dict[str, Any]]:
            sliced = [a[lo:hi] if getattr(a, "ndim", 0) >= 1 and a.shape[0] == n else a for a in flat]
            return tuple(sliced[: len(args)]), dict(zip(kw_names, sliced[len(args) :]))

        head_args, head_kwargs = chunk(0, half)
        if not self.step(head_args, head_kwargs):
            return False  # nothing applied: the whole batch goes eager upstream
        st.ladder_retries += 1
        rest_args, rest_kwargs = chunk(half, n)
        if not self.step(rest_args, rest_kwargs):
            txn.eager_apply(m, rest_args, rest_kwargs)  # the head chunk is in: the rest runs here
            st.fallback("ladder-eager-chunk")
        return True


def copy_into_buffers(state: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor], stats: EngineStats) -> None:
    """Copy each live state that is not its static buffer into it (``donation_copies``)."""
    with torch.no_grad():
        for k, buf in buffers.items():
            if state[k] is not buf:
                buf.copy_(state[k])
                stats.donation_copies += 1
