"""Background drains of the scan queue (counterpart of ``torchmetrics_tpu/engine/async_dispatch.py``).

The scan queue (``engine/scan.py``) cuts the Python per step K-fold, but every Kth
``update`` still pays a drain. With async dispatch on, that drain moves off the
caller:

- **Double buffering.** A full buffer (or one a signature change closes) is swapped
  out under the queue lock and handed to one background worker, while the caller
  fills the next ring of slots. ``update`` is a pure enqueue.
- **On the card.** The caller records an event on its stream after the buffer's last
  slot copy (and the step mask); the worker's side stream waits on it, replays the
  captured ``kb`` graph and records a done event. A buffer's first drain of a
  (ring, ``kb``) pair captures on the caller's thread: the worker only replays.
- **The join.** Every state observation waits for the queue's in-flight drains on the
  host, then makes its current stream wait on the last drain's done event (a stream
  wait, not a device sync), and replays any steps a failed drain handed back, in
  order, on the observer's thread.
- **Backpressure.** At most ``inflight`` swapped buffers wait behind the worker; a
  caller that outruns it blocks on the oldest (``async_backpressure_waits``).
- **Failure = caller replay.** A drain that fails on the worker hands its steps back
  and stops later buffers from running ahead of them; the next join replays them one
  at a time from their slots (``async_replayed_steps``).
- **Overlap.** Each background drain credits ``async_overlap_us``: the part of its
  execution during which no caller waited on it.

Enablement (invalid values raise): ``Metric(async_dispatch=)`` /
``MetricCollection(async_dispatch=)`` (``True`` = on with ``DEFAULT_INFLIGHT``,
``False`` / ``0`` = off, an int in [1, 16] = the bound), then ``async_context`` /
``set_async_dispatch``, then ``TORCHMETRICS_TPU_ASYNC`` (``1``/``on`` = default bound,
``0``/``off``/unset = off, an int in [2, 16] = the bound). It layers on the scan tier:
with no scan queue active the knob is never read.

Left out against the JAX module: the epoch-sync overlap notes, events and histograms.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any, Deque, Dict, Generator, Optional

import torch

from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "ASYNC_ENV_VAR",
    "DEFAULT_INFLIGHT",
    "MAX_INFLIGHT",
    "async_context",
    "async_inflight",
    "coerce_inflight",
    "resolve_async",
    "set_async_dispatch",
]

ASYNC_ENV_VAR = "TORCHMETRICS_TPU_ASYNC"

#: default bound on swapped-out buffers behind the worker: one drain running and one
#: queued while the caller fills the third
DEFAULT_INFLIGHT = 2

#: each pending buffer pins a ring of K slots on the device
MAX_INFLIGHT = 16

_UNSET = object()
_override: Any = _UNSET


# ------------------------------------------------------------------ policy


def coerce_inflight(value: Any) -> Optional[int]:
    """Validate an async knob: ``0``/``False`` = forced off, ``True`` = on with
    ``DEFAULT_INFLIGHT``, an int in [1, MAX_INFLIGHT] = the in-flight bound; ``None``
    passes through (defer to the policy)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return DEFAULT_INFLIGHT if value else 0
    if isinstance(value, int):
        if value == 0:
            return 0
        if 1 <= value <= MAX_INFLIGHT:
            return value
    raise TorchMetricsUserError(
        f"async_dispatch must be a bool, 0 (off), or an integer in-flight bound"
        f" in [1, {MAX_INFLIGHT}] (got {value!r})"
    )


def async_inflight() -> Optional[int]:
    """The active in-flight bound, or ``None`` when async dispatch is off. An
    unrecognized ``TORCHMETRICS_TPU_ASYNC`` value raises."""
    if _override is not _UNSET:
        return _override or None
    raw = os.environ.get(ASYNC_ENV_VAR, "").strip().lower()
    if raw in ("", "0", "off"):
        return None
    if raw in ("1", "on"):
        return DEFAULT_INFLIGHT
    try:
        bound = int(raw)
    except ValueError:
        raise TorchMetricsUserError(
            f"{ASYNC_ENV_VAR}={raw!r} is not a valid async-dispatch setting"
            f" (expected unset/'0'/'off', '1'/'on', or an in-flight bound in"
            f" [2, {MAX_INFLIGHT}])"
        ) from None
    if not (2 <= bound <= MAX_INFLIGHT):
        raise TorchMetricsUserError(
            f"{ASYNC_ENV_VAR}={bound} is out of range: the in-flight bound must"
            f" be in [2, {MAX_INFLIGHT}] ('1' enables the default bound of"
            f" {DEFAULT_INFLIGHT})"
        )
    return bound


def set_async_dispatch(value: Optional[Any]) -> None:
    """Force async dispatch process-wide (``0``/``False`` = off); ``None`` restores
    env resolution."""
    global _override
    _override = _UNSET if value is None else coerce_inflight(value)


@contextmanager
def async_context(inflight: Any = True) -> Generator[None, None, None]:
    """Scoped async dispatch; it engages only where a scan depth is active. Leaving
    the scope drains and joins every queue (reason ``async-scope-exit``), then
    restores the previous policy."""
    global _override
    prev = _override
    _override = coerce_inflight(inflight)
    try:
        yield
    finally:
        try:
            from torchmetrics_tpu_torch.engine.scan import flush_all

            flush_all("async-scope-exit")
        finally:
            _override = prev


def resolve_async(kwarg: Optional[Any]) -> Optional[int]:
    """Per-object resolution: the coerced ``async_dispatch`` kwarg wins (``0`` = off),
    else the process policy."""
    if kwarg is not None:
        return kwarg or None
    return async_inflight()


# ------------------------------------------------------------------ executor


class _AsyncExecutor:
    """One daemon worker draining swapped-out buffers in global FIFO order: buffers of
    one queue never reorder, and all replays share one side stream per device."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._items: Deque[Any] = deque()  # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cv

    def submit(self, work: Any) -> None:
        with self._cv:
            # (re)started lazily: a forked child inherits the module, not the thread
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="tm-torch-async-drain", daemon=True)
                self._thread.start()
            self._items.append(work)
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._items:
                    self._cv.wait()
                work = self._items.popleft()
            try:
                work.queue.worker_execute(work)
            finally:
                work.done.set()


_EXECUTOR = _AsyncExecutor()
_STREAMS: Dict[int, Any] = {}
_STREAMS_LOCK = threading.Lock()


def submit(work: Any) -> None:
    """Hand one swapped-out buffer to the background worker (FIFO)."""
    _EXECUTOR.submit(work)


def side_stream(device: torch.device) -> Any:
    """The worker's stream on ``device`` (made once)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        stream = _STREAMS.get(index)
        if stream is None:
            stream = _STREAMS[index] = torch.cuda.Stream(device=index)
    return stream
