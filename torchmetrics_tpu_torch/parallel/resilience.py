"""Bounded collectives: deadline, retry with backoff, and typed faults (counterpart of
``torchmetrics_tpu/parallel/resilience.py``).

Plain ``torch.distributed`` trusts every rank: a hung or dead rank wedges the epoch-end
gather forever. Every collective the port issues (the packed backbone in
``parallel/packing.py`` and the eager per-tensor path in ``parallel/sync.py``) runs
through ``bounded_collective`` under a policy:

- **Deadline** (``TORCHMETRICS_TPU_SYNC_DEADLINE_MS`` / ``resilience_context``): the
  collective runs on a watchdog thread; past the deadline the caller gets a
  ``CollectiveTimeoutError`` with ``in_flight`` set instead of a hang. The abandoned
  thread is a daemon: a collective cannot be cancelled, only escaped. Such an error is
  never retried, since the abandoned call may still complete and a second one would
  desequence this rank's collective stream against its peers; the process group is
  out of step after it. The error names no culprit; with profiling on, the packed
  sync's timeline (``diag/timeline.py``) names the last straggler (``note_straggler``),
  and the degraded re-plan in ``engine/epoch.py`` excludes that rank and folds this
  rank's own rows without another collective on the out-of-step group. With no hint
  the typed error propagates and no culprit is invented. The worker runs under the
  caller's CUDA device and current stream, so the gather stays ordered after the work
  that produced its input. No deadline: no thread.
- **Bounded retry** (``TORCHMETRICS_TPU_SYNC_RETRIES``, ``TORCHMETRICS_TPU_SYNC_BACKOFF_MS``):
  retryable faults (a planted timeout, a corrupt payload) re-enter the collective up to
  the bound, sleeping ``backoff_ms * 2**attempt``; each retry is a ``sync.retry`` event.
- **Classification**: ``CollectiveTimeoutError``, ``RankUnreachableError`` (not
  retryable: the remedy is the degraded re-plan in ``engine/epoch.py``),
  ``PayloadCorruptError`` (retryable), all ``SyncFaultError``.
- **Payload integrity** (``verify_payload``): the local buffer's crc32 (the JAX
  package's digest of the same bytes) rides the gather as a 4-byte trailer, and every
  member's gathered row is checked against its own trailer. The JAX package checks only
  this rank's echoed row against its local digest; the port checks every row, so every
  rank reaches the same verdict on the same gathered bytes and the ranks retry
  together (one rank retrying alone would desequence the stream). It costs two device
  reads per collective (the local buffer, the gathered rows) and one copy to strip the
  trailers, and only with the policy on.

``TORCHMETRICS_TPU_DEGRADED=0`` forbids the degraded fold. With no deadline, no
``verify_payload`` and no planted fault the wrapper calls the collective directly: the
same collectives and host reads as without it. The policy and the faults are read on
the caller's thread (context variables do not cross to the watchdog thread).
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, Generator, Optional, Sequence

import torch

__all__ = [
    "BACKOFF_ENV_VAR",
    "DEADLINE_ENV_VAR",
    "DEGRADED_ENV_VAR",
    "RETRIES_ENV_VAR",
    "CollectiveTimeoutError",
    "PayloadCorruptError",
    "RankUnreachableError",
    "ResiliencePolicy",
    "SyncFaultError",
    "bounded_collective",
    "bounded_pull",
    "consume_straggler_hint",
    "current_policy",
    "last_straggler_rank",
    "note_straggler",
    "reset_resilience",
    "resilience_context",
    "resilience_snapshot",
]

#: hard wall-clock bound (ms) on one collective; unset or 0 = unbounded
DEADLINE_ENV_VAR = "TORCHMETRICS_TPU_SYNC_DEADLINE_MS"
#: bounded retries for retryable faults (timeout, corrupt payload)
RETRIES_ENV_VAR = "TORCHMETRICS_TPU_SYNC_RETRIES"
#: base backoff (ms) between retries; attempt k sleeps base * 2**k
BACKOFF_ENV_VAR = "TORCHMETRICS_TPU_SYNC_BACKOFF_MS"
#: "0" forbids degraded folds over the surviving membership (allowed by default)
DEGRADED_ENV_VAR = "TORCHMETRICS_TPU_DEGRADED"

DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_MS = 25.0

_CRC_BYTES = 4  # the verify_payload trailer: crc32, little-endian


class SyncFaultError(RuntimeError):
    """A collective failed in a classified way instead of hanging.

    ``label`` is the collective's buffer key (``"reduce:int32"``, ``"meta"``,
    ``"eager:state"``, ...); ``rank`` names the culprit when one is known;
    ``attempts`` is how many tries the policy spent.
    """

    retryable = False

    def __init__(self, message: str, label: str = "", rank: Optional[int] = None, attempts: int = 1):
        super().__init__(message)
        self.label = label
        self.rank = rank
        self.attempts = attempts


class CollectiveTimeoutError(SyncFaultError):
    """The collective exceeded the deadline.

    Retryable as a class (a planted expiry, or a delayed rank classified before the
    collective was entered); an instance that escaped an in-flight collective through
    the watchdog has ``retryable = False`` and ``in_flight = True``.
    """

    retryable = True
    in_flight = False


class RankUnreachableError(SyncFaultError):
    """A rank is gone from the world (not retryable: degrade or fail)."""

    retryable = False


class PayloadCorruptError(SyncFaultError):
    """A gathered row failed its CRC check (retryable)."""

    retryable = True


class ResiliencePolicy:
    """The knobs governing one collective call."""

    __slots__ = ("deadline_ms", "retries", "backoff_ms", "degraded", "verify_payload")

    def __init__(
        self,
        deadline_ms: Optional[float] = None,
        retries: int = DEFAULT_RETRIES,
        backoff_ms: float = DEFAULT_BACKOFF_MS,
        degraded: bool = True,
        verify_payload: bool = False,
    ) -> None:
        self.deadline_ms = None if not deadline_ms else float(deadline_ms)
        self.retries = max(0, int(retries))
        self.backoff_ms = max(0.0, float(backoff_ms))
        self.degraded = bool(degraded)
        self.verify_payload = bool(verify_payload)


_POLICY_VAR: "ContextVar[Optional[ResiliencePolicy]]" = ContextVar("tm_tpu_torch_resilience", default=None)


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def current_policy() -> ResiliencePolicy:
    """The policy in force: an active ``resilience_context`` scope, else the environment."""
    scoped = _POLICY_VAR.get()
    if scoped is not None:
        return scoped
    retries = _env_float(RETRIES_ENV_VAR)
    backoff = _env_float(BACKOFF_ENV_VAR)
    return ResiliencePolicy(
        deadline_ms=_env_float(DEADLINE_ENV_VAR),
        retries=DEFAULT_RETRIES if retries is None else int(retries),
        backoff_ms=DEFAULT_BACKOFF_MS if backoff is None else backoff,
        degraded=os.environ.get(DEGRADED_ENV_VAR, "").strip() != "0",
    )


@contextmanager
def resilience_context(
    deadline_ms: Optional[float] = None,
    retries: int = DEFAULT_RETRIES,
    backoff_ms: float = DEFAULT_BACKOFF_MS,
    degraded: bool = True,
    verify_payload: bool = False,
) -> Generator[ResiliencePolicy, None, None]:
    """A scoped collective policy."""
    policy = ResiliencePolicy(deadline_ms, retries, backoff_ms, degraded, verify_payload)
    token = _POLICY_VAR.set(policy)
    try:
        yield policy
    finally:
        _POLICY_VAR.reset(token)


# ------------------------------------------------------------------ counters

# process-wide fault facts, zeroed by reset_engine_stats; the epoch engine diffs
# total_retries() around an exchange into EngineStats.sync_retries
_COUNTS: Dict[str, int] = {}

#: the last straggler rank the packed-sync timeline named (diag/timeline.py): a timeout
#: that does not know its culprit falls back to it, once
_last_straggler: Optional[int] = None


def _count(key: str) -> None:
    _COUNTS[key] = _COUNTS.get(key, 0) + 1


def total_retries() -> int:
    return _COUNTS.get("retries", 0)


def note_straggler(rank: int) -> None:
    """Remember the rank a straggler detector last named (the degraded re-plan's hint)."""
    global _last_straggler
    _last_straggler = int(rank)


def last_straggler_rank() -> Optional[int]:
    return _last_straggler


def consume_straggler_hint() -> Optional[int]:
    """Read and clear the straggler hint: each attribution is spent once, so a stale
    one never excludes a healthy rank's data."""
    global _last_straggler
    rank, _last_straggler = _last_straggler, None
    return rank


def resilience_snapshot() -> Dict[str, Any]:
    """Counters and the policy in force (sorted keys)."""
    policy = current_policy()
    return {
        "counts": {k: _COUNTS[k] for k in sorted(_COUNTS)},
        "deadline_ms": policy.deadline_ms,
        "retries": policy.retries,
        "backoff_ms": policy.backoff_ms,
        "degraded": policy.degraded,
        "last_straggler_rank": _last_straggler,
    }


def reset_resilience() -> None:
    """Zero the fault and retry counters and the straggler hint; the policy is
    configuration and stays."""
    global _last_straggler
    _COUNTS.clear()
    _last_straggler = None


# ------------------------------------------------------------------ the wrapper


def _payload_crc(payload: torch.Tensor) -> int:
    """crc32 over the payload's raw bytes, the JAX package's digest of the same bytes
    (one device read for a tensor on the card)."""
    flat = payload.detach().contiguous().reshape(-1).view(torch.uint8)
    return zlib.crc32(flat.cpu().numpy().tobytes()) & 0xFFFFFFFF


def _local_rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _frame(payload: torch.Tensor) -> torch.Tensor:
    """The payload's bytes with its crc32 appended, on the payload's device."""
    crc = _payload_crc(payload)
    flat = payload.detach().contiguous().reshape(-1).view(torch.uint8)
    trailer = torch.tensor(list(crc.to_bytes(_CRC_BYTES, "little")), dtype=torch.uint8, device=payload.device)
    return torch.cat([flat, trailer])


def _unframe(
    gathered: Any, payload: torch.Tensor, label: str, members: Optional[Sequence[int]], attempts: int
) -> Any:
    """Check every member's row of a framed gather against its trailer; return the rows
    without trailers, in the payload's dtype and shape, as the call returned them (a
    ``(world, ...)`` tensor or a list)."""
    rows = list(gathered) if isinstance(gathered, (list, tuple)) else None
    stacked = torch.stack(rows) if rows is not None else gathered
    host = stacked.cpu().numpy()  # one device read for every row
    for r in range(host.shape[0]) if members is None else members:
        if r >= host.shape[0]:
            continue
        body, trailer = host[r, :-_CRC_BYTES], host[r, -_CRC_BYTES:]
        got = zlib.crc32(body.tobytes()) & 0xFFFFFFFF
        want = int.from_bytes(trailer.tobytes(), "little")
        if got != want:
            raise PayloadCorruptError(
                f"collective {label!r}: gathered row {r} does not match its crc trailer"
                f" (crc {got:#010x} != {want:#010x}; checked on rank {_local_rank()}, attempt {attempts})",
                label=label,
                rank=r,
                attempts=attempts,
            )
    nbytes = stacked.shape[-1] - _CRC_BYTES
    shape = tuple(payload.shape)
    if rows is not None:
        return [row[:nbytes].view(payload.dtype).reshape(shape) for row in rows]
    body = stacked[:, :nbytes].contiguous().view(payload.dtype)
    return body.reshape((stacked.shape[0],) + shape)


def _call_with_deadline(call: Callable[[], Any], deadline_ms: float, label: str, attempts: int) -> Any:
    """Run ``call`` on a watchdog thread, under the caller's CUDA device and stream;
    escape with a typed timeout past the deadline."""
    box: Dict[str, Any] = {}
    device = stream = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        device = torch.cuda.current_device()
        stream = torch.cuda.current_stream(device)

    def run() -> None:
        try:
            if stream is None:
                box["out"] = call()
            else:
                with torch.cuda.device(device), torch.cuda.stream(stream):
                    box["out"] = call()
        except BaseException as exc:  # noqa: BLE001 -- re-raised on the caller's thread
            box["err"] = exc

    worker = threading.Thread(target=run, daemon=True, name=f"tm-collective-{label}")
    worker.start()
    worker.join(deadline_ms / 1e3)
    if worker.is_alive():
        err = CollectiveTimeoutError(
            f"collective {label!r} exceeded the {deadline_ms:g} ms deadline"
            f" (attempt {attempts}); the epoch would have hung without it."
            " The in-flight collective was abandoned, so this error is not"
            " retried: re-entering could desequence the collective stream"
            " if the abandoned call later completes",
            label=label,
            rank=None,  # culprit attribution is the degraded re-plan's job (the straggler hint)
            attempts=attempts,
        )
        err.retryable = False
        err.in_flight = True
        raise err
    if "err" in box:
        raise box["err"]
    return box["out"]


def _retry_or_raise(exc: SyncFaultError, label: str, attempt: int, policy: ResiliencePolicy) -> None:
    """Count the fault; record and re-raise it when it is final, else record the retry
    and sleep the backoff."""
    from torchmetrics_tpu_torch.diag import trace as _diag

    _count(f"fault:{type(exc).__name__}")
    if not exc.retryable or attempt >= policy.retries:
        _diag.record(
            "sync.fault", "", label=label, error=type(exc).__name__,
            rank=exc.rank, attempts=exc.attempts, retryable=exc.retryable,
        )
        raise exc
    _count("retries")
    _diag.record(
        "sync.retry", "", label=label, error=type(exc).__name__,
        rank=exc.rank, attempt=exc.attempts, backoff_ms=policy.backoff_ms * (2 ** attempt),
    )
    if policy.backoff_ms:
        time.sleep(policy.backoff_ms * (2 ** attempt) / 1e3)


def bounded_collective(
    call: Callable[[Any], Any],
    label: str = "",
    payload: Any = None,
    members: Optional[Sequence[int]] = None,
    on_enter: Optional[Callable[[], None]] = None,
) -> Any:
    """Run one collective under the active policy: ``call(payload)`` gathers ``payload``
    from every rank and returns a ``(world, ...)`` tensor or a list of per-rank tensors.

    ``members`` is the plan's live membership: rank-scoped faults consult it, and
    ``verify_payload`` checks the members' rows. The JAX ``call`` takes no argument;
    here it takes the tensor to gather, so that ``verify_payload`` can gather the
    payload framed with its crc32. ``on_enter()`` runs as each attempt enters the
    collective, after the planted pre-collective faults (a delayed rank has slept by
    then) and before the payload is framed. Raises a ``SyncFaultError`` when the
    policy's bounds are spent.
    """
    from torchmetrics_tpu_torch.parallel import faults as _faults

    policy = current_policy()
    verify = policy.verify_payload and isinstance(payload, torch.Tensor)
    if policy.deadline_ms is None and not verify and not _faults.active_faults():
        if on_enter is not None:
            on_enter()
        return call(payload)
    attempt = 0
    while True:
        attempts = attempt + 1
        try:
            _faults.apply_before(label, members, policy.deadline_ms, attempts)
            if on_enter is not None:
                on_enter()
            sent = _frame(payload) if verify else payload
            if policy.deadline_ms is not None:
                out = _call_with_deadline(lambda sent=sent: call(sent), policy.deadline_ms, label, attempts)
            else:
                out = call(sent)
            out = _faults.apply_after(label, members, out)
            return _unframe(out, payload, label, members, attempts) if verify else out
        except SyncFaultError as exc:
            exc.attempts = attempts
            _retry_or_raise(exc, label, attempt, policy)
            attempt += 1


def bounded_pull(
    fetch: Callable[[], Any],
    label: str = "",
    rank: Optional[int] = None,
    members: Optional[Sequence[int]] = None,
) -> Any:
    """Run one point-to-point fetch under the policy: the deadline, retries and fault
    hooks of ``bounded_collective``, with two differences. A pull is idempotent, so a
    deadline expiry that abandoned an in-flight fetch is retried; and an untyped
    transport failure is classified as ``RankUnreachableError`` naming ``rank``.
    """
    from torchmetrics_tpu_torch.parallel import faults as _faults

    policy = current_policy()
    attempt = 0
    while True:
        attempts = attempt + 1
        try:
            _faults.apply_before(label, members, policy.deadline_ms, attempts)
            try:
                if policy.deadline_ms is not None:
                    out = _call_with_deadline(fetch, policy.deadline_ms, label, attempts)
                else:
                    out = fetch()
            except SyncFaultError:
                raise
            except Exception as exc:  # noqa: BLE001 -- a transport failure, classified here
                raise RankUnreachableError(
                    f"pull {label!r} failed to reach its pod"
                    f" ({type(exc).__name__}: {exc}, attempt {attempts})",
                    label=label,
                    rank=rank,
                    attempts=attempts,
                ) from exc
            return _faults.apply_after(label, members, out)
        except SyncFaultError as exc:
            exc.attempts = attempts
            if isinstance(exc, CollectiveTimeoutError):
                # an abandoned in-flight fetch is safe to issue again (an idempotent read)
                exc.retryable = exc.retryable or exc.in_flight
            if exc.rank is None:
                exc.rank = rank
            _retry_or_raise(exc, label, attempt, policy)
            attempt += 1

