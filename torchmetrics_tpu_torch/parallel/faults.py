"""Deterministic fault injection at the collective boundary (counterpart of
``torchmetrics_tpu/parallel/faults.py``).

The harness plants faults where ``parallel/resilience.bounded_collective`` guards every
collective the port issues (the packed backbone ``all_gather_backbone`` and the eager
``gather_all_tensors``), so tests and ``chip_smoke.py`` drive the production path:

=====================  ======================================================
``CollectiveTimeout``  the matching collective raises ``CollectiveTimeoutError``
                       (a planted deadline expiry) before it is entered
``RankDrop``           ``rank`` is unreachable: matching collectives raise
                       ``RankUnreachableError`` while the rank is a member of
                       the live membership (persistent by default)
``DelayRank``          ``rank`` genuinely sleeps before the collective; past the
                       policy's deadline the call times out naming that rank
``CorruptPayload``     every byte of the gathered row of ``rank`` is flipped
                       after the collective (``view(torch.uint8) ^ 0xFF`` on a
                       copy, on the gathered tensor's own device)
=====================  ======================================================

A fault fires on the Nth matching call (``after`` skips, ``times`` bounds), never on a
random draw, and fires on every process where it is planted: a ``RankDrop(rank=1)``
planted on both ranks of a world raises on both before either enters the collective,
so both re-plan to the same membership. Filtering faults by the local rank would
desequence the ranks' collective streams. ``fault_context`` is a contextvar scope.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Generator, Optional, Sequence, Tuple

import torch

__all__ = [
    "CollectiveTimeout",
    "CorruptPayload",
    "DelayRank",
    "Fault",
    "RankDrop",
    "active_faults",
    "apply_after",
    "apply_before",
    "fault_context",
]


class Fault:
    """One deterministic injection rule.

    Args:
        label: collective label to match: ``None`` matches any, a trailing ``*``
            matches by prefix (``"reduce:*"``), otherwise exact.
        rank: the rank this fault models (required for the rank-scoped kinds).
        times: matching calls that fire (``None``: every one).
        after: matching calls to skip before the first fire.
    """

    kind = ""
    rank_scoped = False

    def __init__(
        self,
        label: Optional[str] = None,
        rank: Optional[int] = None,
        times: Optional[int] = 1,
        after: int = 0,
    ) -> None:
        if self.rank_scoped and rank is None:
            raise ValueError(f"{type(self).__name__} requires a target rank")
        self.label = label
        self.rank = rank
        self.times = times
        self.after = int(after)
        self.fired = 0
        self._seen = 0

    def _matches(self, label: str) -> bool:
        if self.label is None:
            return True
        if self.label.endswith("*"):
            return label.startswith(self.label[:-1])
        return label == self.label

    def due(self, label: str, members: Optional[Sequence[int]]) -> bool:
        """Consume one matching call; True when this one fires.

        Membership is a precondition, not a consumption: a rank-scoped fault whose rank
        a degraded re-plan excluded neither fires nor counts the call.
        """
        if not self._matches(label):
            return False
        if self.rank_scoped and members is not None and self.rank not in members:
            return False
        self._seen += 1
        if self._seen <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class CollectiveTimeout(Fault):
    """The matching collective times out (a planted deadline expiry)."""

    kind = "timeout"


class RankDrop(Fault):
    """``rank`` is dead: matching collectives fail while it is in the membership.

    Persistent by default (``times=None``); the degraded re-plan that removes the rank
    from the membership is what stops it firing.
    """

    kind = "rank-drop"
    rank_scoped = True

    def __init__(self, rank: int, label: Optional[str] = None, times: Optional[int] = None, after: int = 0):
        super().__init__(label=label, rank=rank, times=times, after=after)


class DelayRank(Fault):
    """``rank`` arrives late: the call sleeps ``delay_ms`` first, and past the policy's
    deadline it times out naming the rank."""

    kind = "delay"
    rank_scoped = True

    def __init__(self, rank: int, delay_ms: float, label: Optional[str] = None, times: Optional[int] = 1, after: int = 0):
        super().__init__(label=label, rank=rank, times=times, after=after)
        self.delay_ms = float(delay_ms)


class CorruptPayload(Fault):
    """Flip every byte of the gathered row of ``rank`` after the collective returns."""

    kind = "corrupt"
    rank_scoped = True

    def __init__(self, rank: int, label: Optional[str] = None, times: Optional[int] = 1, after: int = 0):
        super().__init__(label=label, rank=rank, times=times, after=after)


_FAULTS_VAR: "ContextVar[Tuple[Fault, ...]]" = ContextVar("tm_tpu_torch_faults", default=())


@contextmanager
def fault_context(*faults: Fault) -> Generator[Tuple[Fault, ...], None, None]:
    """Scope the given faults over every bounded collective inside the block."""
    for f in faults:
        if not isinstance(f, Fault):
            raise TypeError(f"expected Fault instances, got {type(f).__name__}")
    token = _FAULTS_VAR.set(_FAULTS_VAR.get() + tuple(faults))
    try:
        yield tuple(faults)
    finally:
        _FAULTS_VAR.reset(token)


def active_faults() -> Tuple[Fault, ...]:
    return _FAULTS_VAR.get()


def apply_before(label: str, members: Optional[Sequence[int]], deadline_ms: Optional[float], attempt: int) -> None:
    """Fire the pre-collective faults (timeout, drop, delay) for this call."""
    from torchmetrics_tpu_torch.parallel import resilience as _res

    for fault in _FAULTS_VAR.get():
        if fault.kind == "timeout" and fault.due(label, members):
            raise _res.CollectiveTimeoutError(
                f"planted collective timeout on {label!r} (attempt {attempt})",
                label=label,
                rank=fault.rank,
                attempts=attempt,
            )
        if fault.kind == "rank-drop" and fault.due(label, members):
            raise _res.RankUnreachableError(
                f"planted rank-drop: rank {fault.rank} unreachable in {label!r}",
                label=label,
                rank=fault.rank,
                attempts=attempt,
            )
        if fault.kind == "delay" and fault.due(label, members):
            time.sleep(fault.delay_ms / 1e3)  # the rank is late for real
            if deadline_ms is not None and fault.delay_ms > deadline_ms:
                raise _res.CollectiveTimeoutError(
                    f"rank {fault.rank} exceeded the {deadline_ms:g} ms deadline on"
                    f" {label!r} (arrived after {fault.delay_ms:g} ms, attempt {attempt})",
                    label=label,
                    rank=fault.rank,
                    attempts=attempt,
                )


def _flip_row(gathered: Any, rank: int) -> Any:
    """A copy of ``gathered`` (a ``(world, ...)`` tensor or a list of per-rank
    tensors) with every byte of row ``rank`` flipped, on the row's own device."""
    if isinstance(gathered, (list, tuple)):
        if rank >= len(gathered):
            return gathered
        rows = list(gathered)
        row = rows[rank].contiguous()
        rows[rank] = (row.reshape(-1).view(torch.uint8) ^ 0xFF).view(row.dtype).reshape(row.shape)
        return rows
    if gathered.ndim < 1 or rank >= gathered.shape[0]:
        return gathered
    out = gathered.clone(memory_format=torch.contiguous_format)
    row = out[rank]
    row.copy_((row.reshape(-1).view(torch.uint8) ^ 0xFF).view(row.dtype).reshape(row.shape))
    return out


def apply_after(label: str, members: Optional[Sequence[int]], gathered: Any) -> Any:
    """Fire the post-collective faults (payload corruption) on the gathered rows."""
    out = gathered
    for fault in _FAULTS_VAR.get():
        if fault.kind != "corrupt" or not fault.due(label, members):
            continue
        if fault.rank is not None:
            out = _flip_row(out, fault.rank)
    return out
