"""Runtime profiling: device-time attribution and sampled completion probes (counterpart
of ``torchmetrics_tpu/diag/profile.py``).

Every ``dispatch_us`` the flight recorder measures is host wall-time around an
asynchronous graph replay: the launch cost, not device time. This module closes the gap
three ways without breaking the strict transfer guard on unsampled steps:

1. **Attribution scopes.** The engines wrap every replay in ``dispatch_scope``, named
   ``tm:<owner>:<kind>:<signature>`` (``engine/compiled.annotation_scope``): an NVTX range
   on a CUDA device, and a ``torch.profiler.record_function`` while a torch profiler is
   active (the JAX package's ``TraceAnnotation``). The ``record_function`` is gated on
   the profiler being on because it costs ~10 µs per call when nothing records it.
2. **Sampled completion probes.** With profiling active, every Nth *warm* dispatch is
   bracketed by two CUDA events on the current stream and followed by a wait on the end
   event inside ``transfer_allowed("profile-probe")``. ``device_us`` keeps the JAX
   meaning (dispatch start to results ready, on the host clock); the probe's overhead is
   the wait alone; the events' own elapsed time is an extra series, ``device_event_us``.
   On the CPU the probe has nothing to wait for and records ``device_us`` only.
3. **The cross-rank clock.** :func:`epoch_now_us` is the per-process microsecond clock
   the packed-sync timeline (``diag/timeline.py``, ``parallel/packing.py``) stamps into
   the int32 metadata gather; :func:`note_sync_exit` marks the barrier-exit instant that
   anchors cross-rank clock-offset estimation.

Enablement (first hit wins): an active :func:`profile_context` scope, a
:func:`set_profile_every_n` override, then ``TORCHMETRICS_TPU_PROFILE`` (``"1"``
samples every ``DEFAULT_EVERY_N`` warm dispatches, an integer > 1 sets ``every_n``,
``"0"``/unset disables). Profiling extends the packed-sync metadata layout: enable it on
every rank or none (the layout version stamped into the gather fails loud on mismatch).

The straggler threshold (``sync.straggler`` events and
``EngineStats.sync_straggler_flags`` when a rank's corrected barrier arrival trails the
world by more than the threshold) lives here too: ``TORCHMETRICS_TPU_STRAGGLER_US`` /
:func:`set_straggler_threshold_us`, default 1000 µs.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from time import perf_counter
from typing import Any, Dict, Generator, Optional, Tuple

__all__ = [
    "DEFAULT_EVERY_N",
    "PROFILE_ENV_VAR",
    "STRAGGLER_ENV_VAR",
    "active_profile",
    "dispatch_scope",
    "epoch_now_us",
    "last_sync_exit_us",
    "note_probe",
    "note_sync_exit",
    "probe_due",
    "profile_context",
    "profile_snapshot",
    "reset_profile",
    "set_profile_every_n",
    "set_straggler_threshold_us",
    "straggler_threshold_us",
    "timeline_enabled",
]

#: env knob: "1" = sample every DEFAULT_EVERY_N warm dispatches, int > 1 =
#: every_n, "0"/unset = off
PROFILE_ENV_VAR = "TORCHMETRICS_TPU_PROFILE"
DEFAULT_EVERY_N = 16

#: env knob: arrival-skew threshold (µs) past which a packed sync records a
#: ``sync.straggler`` event and bumps ``EngineStats.sync_straggler_flags``
STRAGGLER_ENV_VAR = "TORCHMETRICS_TPU_STRAGGLER_US"
DEFAULT_STRAGGLER_US = 1000.0

_PROFILE_VAR: "ContextVar[Optional[int]]" = ContextVar("tm_tpu_profile_every_n", default=None)
_every_n_override: Optional[int] = None
_straggler_override: Optional[float] = None

# (env_value, parsed) cache — a steady env var costs one read + compare per call
_env_state: Tuple[str, Optional[int]] = ("", None)

# probe accounting: (owner, kind) -> counts. Bounded by the live engine
# population; cleared by reset_profile() in the reset_engine_stats lockstep.
_dispatch_counts: Dict[Tuple[str, str], int] = {}
_probe_counts: Dict[Tuple[str, str], int] = {}
_probe_wait_us: Dict[Tuple[str, str], float] = {}

# the per-process microsecond clock timeline timestamps ride (int32-safe via
# masking in timeline.py); one epoch per process keeps every stamp comparable
_T0 = perf_counter()

# barrier-exit anchor: local timestamp at the end of the previous packed-sync
# exchange. All ranks exit a collective at (approximately) the same true
# instant, so gathering each rank's *previous* exit stamp next sync estimates
# per-rank clock offsets without any extra collective.
_last_sync_exit_us = 0


def _parse_env(raw: str) -> Optional[int]:
    if not raw or raw == "0":
        return None
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_EVERY_N
    return n if n > 1 else DEFAULT_EVERY_N


def active_profile() -> Optional[int]:
    """The active sampling rate (``every_n``), or None when profiling is off."""
    scoped = _PROFILE_VAR.get()
    if scoped is not None:
        return scoped
    if _every_n_override is not None:
        return _every_n_override
    global _env_state
    raw = os.environ.get(PROFILE_ENV_VAR, "").strip()
    if raw != _env_state[0]:
        _env_state = (raw, _parse_env(raw))
    return _env_state[1]


def set_profile_every_n(every_n: Optional[int]) -> None:
    """Force the sampling rate process-wide; ``None`` restores env/default."""
    global _every_n_override
    if every_n is not None and (not isinstance(every_n, int) or every_n < 1):
        raise ValueError(f"every_n must be a positive int or None, got {every_n!r}")
    _every_n_override = every_n


@contextmanager
def profile_context(every_n: int = DEFAULT_EVERY_N) -> Generator[None, None, None]:
    """Scoped profiling: sample every ``every_n``-th warm dispatch.

    Enable on EVERY rank of a multi-process world (the packed-sync timeline
    entries extend the metadata layout; the stamped layout version fails loud
    on asymmetric enablement). ``every_n=1`` probes every warm dispatch —
    useful in tests, ruinous on a real async pipeline.
    """
    if not isinstance(every_n, int) or every_n < 1:
        raise ValueError(f"every_n must be a positive int, got {every_n!r}")
    token = _PROFILE_VAR.set(every_n)
    try:
        yield
    finally:
        _PROFILE_VAR.reset(token)


def timeline_enabled() -> bool:
    """Whether packed syncs stamp cross-rank timeline entries (= profiling on)."""
    return active_profile() is not None


# ------------------------------------------------------------------ probes


def probe_due(owner: str, kind: str) -> bool:
    """Count one warm dispatch for ``(owner, kind)``; True on every Nth.

    Callers invoke this only when profiling is active and the dispatch is
    warm (cache-hit) — cold dispatches fold compile time into their latency
    and would poison the device-time distribution.
    """
    every_n = active_profile()
    if every_n is None:
        return False
    key = (owner, kind)
    n = _dispatch_counts.get(key, 0) + 1
    _dispatch_counts[key] = n
    return n % every_n == 0


def note_probe(owner: str, kind: str, wait_us: float) -> None:
    """Account one completed probe and its blocking wait."""
    key = (owner, kind)
    _probe_counts[key] = _probe_counts.get(key, 0) + 1
    _probe_wait_us[key] = _probe_wait_us.get(key, 0.0) + float(wait_us)


def profile_snapshot() -> Dict[str, Any]:
    """Probe accounting (deterministically sorted; byte-stable JSON)."""
    per_site = {
        f"{owner}:{kind}": {
            "warm_dispatches": _dispatch_counts.get((owner, kind), 0),
            "probes": _probe_counts.get((owner, kind), 0),
            "wait_us": round(_probe_wait_us.get((owner, kind), 0.0), 3),
        }
        for owner, kind in sorted(set(_dispatch_counts) | set(_probe_counts))
    }
    return {
        "active": active_profile() is not None,
        "every_n": active_profile(),
        "probes": sum(_probe_counts.values()),
        "probe_wait_us": round(sum(_probe_wait_us.values()), 3),
        "per_site": per_site,
    }


def reset_profile() -> None:
    """Zero the probe accounting (``reset_engine_stats`` lockstep); the
    enablement knobs are configuration, not measurement, and survive."""
    _dispatch_counts.clear()
    _probe_counts.clear()
    _probe_wait_us.clear()


# ------------------------------------------------------------------ clock


def epoch_now_us() -> int:
    """Microseconds since this process's profile epoch (monotonic clock)."""
    return int((perf_counter() - _T0) * 1e6)


def note_sync_exit() -> None:
    """Mark 'now' as the barrier-exit instant of the just-finished packed sync."""
    global _last_sync_exit_us
    _last_sync_exit_us = epoch_now_us()


def last_sync_exit_us() -> int:
    """The previous packed sync's barrier-exit stamp (0 = no sync yet)."""
    return _last_sync_exit_us


# ------------------------------------------------------------------ straggler


def straggler_threshold_us() -> float:
    """Arrival-skew threshold (µs) for flagging a packed-sync straggler."""
    if _straggler_override is not None:
        return _straggler_override
    raw = os.environ.get(STRAGGLER_ENV_VAR, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_STRAGGLER_US


def set_straggler_threshold_us(value: Optional[float]) -> None:
    """Override the straggler threshold; ``None`` restores env/default."""
    global _straggler_override
    _straggler_override = None if value is None else float(value)


# ------------------------------------------------------------------ attribution


@contextmanager
def dispatch_scope(name: str, device: Any) -> Generator[None, None, None]:
    """The attribution scope of one replay: an NVTX range on a CUDA device, and a
    ``torch.profiler.record_function`` while a torch profiler records."""
    import torch

    recording = torch._C._autograd._profiler_enabled()
    cuda = getattr(device, "type", "") == "cuda"
    if cuda:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name) if recording else nullcontext():
            yield
    finally:
        if cuda:
            torch.cuda.nvtx.range_pop()
