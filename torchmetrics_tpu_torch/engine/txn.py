"""Transactional state integrity (counterpart of ``torchmetrics_tpu/engine/txn.py``).

Three pieces:

- **Admission** (``build_admission``): a per-batch check planned once per step
  signature from the input dtypes: a float input is poisoned when any value is not
  finite; an integer input of a metric with an int ``num_classes`` is poisoned when
  any label is ``< 0`` or ``>= num_classes``. The flag is a 0-d device bool, never read
  on the host in the hot loop. The rule is copied as it stands: a multiclass batch
  with ``ignore_index=-1`` labels reads as poisoned in both packages.
- **Transaction** (``transact``): every state of the step becomes
  ``torch.where(poisoned, old, new)``, the compensation residuals included, so a
  quarantined batch leaves (value, residual) bit-exact; the ``__quarantine__``
  counter adds the flag. The one-step graphs, the scan graphs (``engine/scan.py``)
  and the eager path (``eager_update``) share it. The counter reaches the host only at
  ``read_quarantine`` (``Metric.compute``), where the delta lands in
  ``EngineStats.quarantined_batches``.
- **Fallback ladder** (``classify_dispatch_error`` and ``CompiledUpdate._ladder_step``):
  a classified failure while building a signature (an out-of-memory error allocating
  the static inputs or capturing the graph) retries the batch as half-bucket chunks,
  then eagerly, for this step only; a signature that fails ``TRANSIENT_RETRY_BUDGET``
  times is demoted like a structural failure.

Modes (``TORCHMETRICS_TPU_QUARANTINE`` / ``quarantine_context``, override first):

==========  ================================================================
``0``/unset  off, the default
``1``        quarantine: poisoned batches are skipped on the device, counted
``error``    the admission check runs on the host before any state mutation and
             raises ``QuarantinedBatchError`` (one device sync per step, asked for)
==========  ================================================================

Enable the same mode on every rank: the counter rides the packed sync's reduce
buffer (``parallel/packing.py``) and sums across ranks.

With the sentinel on (``diag/sentinel.py``) a quarantined batch sets the sticky
``input_poisoned`` bit, in the graphs (``engine/compiled.write_step``) and on the eager
path alike. Every host read of the admission flag or the counter runs inside
``transfer_allowed`` (``quarantine-check``, ``quarantine-read``); a read that surfaces
growth records an ``update.quarantine`` event and counts the batches as ``quarantined``
exclusions of the lineage watermark (``diag/lineage.py``).
"""

from __future__ import annotations

import os
import weakref
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.engine.statespec import QUARANTINE_KEY, RIDER_KEYS
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "ATTR",
    "MODE_ERROR",
    "MODE_OFF",
    "MODE_QUARANTINE",
    "QUARANTINE_ENV_VAR",
    "QuarantinedBatchError",
    "STATE_KEY",
    "admission_check_or_raise",
    "build_admission",
    "classify_and_demote",
    "classify_dispatch_error",
    "eager_apply",
    "eager_update",
    "ensure_count",
    "quarantine_context",
    "quarantine_enabled",
    "quarantine_error",
    "quarantine_mode",
    "quarantine_report",
    "read_quarantine",
    "reset_quarantine",
    "set_quarantine_mode",
    "transact",
]

QUARANTINE_ENV_VAR = "TORCHMETRICS_TPU_QUARANTINE"

#: the rider key of the quarantine counter inside a compiled step's state dict
STATE_KEY = QUARANTINE_KEY
#: the attribute carrying the live device counter on a metric
ATTR = "_quarantined_count"

MODE_OFF = "0"
MODE_QUARANTINE = "1"
MODE_ERROR = "error"

_mode_override: Optional[str] = None
_env_mode_cache: tuple = ("", MODE_OFF)  # (raw env value, parsed mode)

# metrics carrying a counter, by id (a metric's hash follows its state tensors)
_REGISTRY: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class QuarantinedBatchError(TorchMetricsUserError):
    """``TORCHMETRICS_TPU_QUARANTINE=error``: a batch failed admission.

    Raised before any state mutation: the states and ``update_count`` are untouched,
    on the compiled and the eager path alike.
    """


# ------------------------------------------------------------------ policy


def quarantine_mode() -> str:
    """The active mode: ``MODE_OFF``, ``MODE_QUARANTINE`` or ``MODE_ERROR``.

    An unrecognized env value raises. The parse is cached on the raw value: the
    update wrapper reads the mode on every step.
    """
    global _env_mode_cache
    if _mode_override is not None:
        return _mode_override
    raw = os.environ.get(QUARANTINE_ENV_VAR, "")
    if raw == _env_mode_cache[0]:
        return _env_mode_cache[1]
    val = raw.strip().lower()
    if val in ("", "0", "off"):
        mode = MODE_OFF
    elif val in ("1", "on", "quarantine"):
        mode = MODE_QUARANTINE
    elif val == "error":
        mode = MODE_ERROR
    else:
        raise TorchMetricsUserError(
            f"{QUARANTINE_ENV_VAR}={val!r} is not a recognized quarantine mode "
            "(expected unset/'0'/'off', '1'/'on'/'quarantine', or 'error')"
        )
    _env_mode_cache = (raw, mode)
    return mode


def quarantine_enabled() -> bool:
    """Whether updates apply the quarantine transaction."""
    return quarantine_mode() == MODE_QUARANTINE


def quarantine_error() -> bool:
    """Whether admission failures raise instead of quarantining."""
    return quarantine_mode() == MODE_ERROR


def _coerce_mode(value: Optional[Any]) -> Optional[str]:
    if value is None:
        return None
    if value is True:
        return MODE_QUARANTINE
    if value is False:
        return MODE_OFF
    mode = str(value).strip().lower()
    if mode in (MODE_OFF, MODE_QUARANTINE, MODE_ERROR):
        return mode
    raise ValueError(f"quarantine mode must be one of '0', '1', 'error' (got {value!r})")


def set_quarantine_mode(value: Optional[Any]) -> None:
    """Force the mode process-wide (``True``/``"1"``, ``False``/``"0"``, ``"error"``);
    ``None`` restores env resolution."""
    global _mode_override
    _mode_override = _coerce_mode(value)


@contextmanager
def quarantine_context(mode: Any = True) -> Generator[None, None, None]:
    """Scoped quarantine mode. Toggling mid-stream builds the affected signatures once
    more (the counter joins the step's state)."""
    global _mode_override
    prev = _mode_override
    _mode_override = _coerce_mode(mode)
    try:
        yield
    finally:
        _mode_override = prev


# ------------------------------------------------------------------ admission


def _input_bounds(metric: Any) -> Optional[int]:
    """The integer label bound for range checks, when the metric declares one."""
    bound = getattr(metric, "num_classes", None)
    if isinstance(bound, bool) or not isinstance(bound, (int, np.integer)):
        return None
    return int(bound) if int(bound) > 0 else None


def build_admission(metric: Any, inputs: Sequence[Any]) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
    """The per-batch admission check, planned once from the example dtypes.

    Zero pad rows (``engine/bucketing.py``) are finite and in range, so padding never
    reads as poison. With nothing to check the flag is a constant False.
    """
    checks: List[Tuple[int, str]] = []
    bound = _input_bounds(metric)
    for i, a in enumerate(inputs):
        if not isinstance(a, torch.Tensor):
            continue
        if a.is_floating_point() or a.is_complex():
            checks.append((i, "finite"))
        elif a.dtype != torch.bool and bound is not None:
            checks.append((i, "range"))
    device = next((a.device for a in inputs if isinstance(a, torch.Tensor)), torch.device("cpu"))

    def admission(flat: Sequence[torch.Tensor]) -> torch.Tensor:
        poisoned = torch.zeros((), dtype=torch.bool, device=device)
        for i, check in checks:
            x = flat[i]
            if check == "finite":
                poisoned = poisoned | ~torch.isfinite(x).all()
            else:
                poisoned = poisoned | (x < 0).any() | (x >= bound).any()
        return poisoned

    return admission


def transact(old: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], poisoned: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The state transaction: every non-counter entry of ``new`` selected against its
    pre-update value, residuals included; the counter adds the flag."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in new.items():
        if k in RIDER_KEYS:
            continue
        out[k] = torch.where(poisoned, old[k], v)
    if STATE_KEY in old:
        out[STATE_KEY] = old[STATE_KEY] + poisoned.to(old[STATE_KEY].dtype)
    return out


# ------------------------------------------------------------------ eager parity


def _flat_inputs(args: Sequence[Any], kwargs: Dict[str, Any]) -> List[Any]:
    return list(args) + [kwargs[k] for k in sorted(kwargs)]


def admission_check_or_raise(metric: Any, args: Sequence[Any], kwargs: Dict[str, Any]) -> None:
    """``error`` mode: the admission check on the host before any state mutation (one
    device sync, asked for), on the compiled and the eager route alike."""
    from torchmetrics_tpu_torch.diag import trace
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    inputs = _flat_inputs(args, kwargs)
    poisoned = build_admission(metric, inputs)(inputs)
    with transfer_allowed("quarantine-check"):
        bad = bool(poisoned)
    if bad:
        trace.record("update.quarantine", type(metric).__name__, mode="error")
        raise QuarantinedBatchError(
            f"batch failed admission for {type(metric).__name__}: a float input is"
            " non-finite or an integer label is out of [0, num_classes)."
            " TORCHMETRICS_TPU_QUARANTINE=error raises instead of quarantining;"
            " use mode '1' to skip poisoned batches on the device instead."
        )


def eager_update(metric: Any, run_update: Callable[[], None], args: Sequence[Any], kwargs: Dict[str, Any]) -> None:
    """The quarantine-guarded eager update.

    Fixed-shape tensor states get the device select and counter increment of the
    compiled step. A state whose kind or shape changed under the update (a list
    append) cannot be selected on the device: the flag is read on the host and the
    pre-update references come back wholesale on poison.
    """
    from torchmetrics_tpu_torch.engine import numerics

    inputs = _flat_inputs(args, kwargs)
    admission = build_admission(metric, inputs)
    old: Dict[str, Any] = {}
    for k in metric._defaults:
        v = getattr(metric, k)
        old[k] = list(v) if isinstance(v, list) else v
    # the residuals roll back with the states; absent before reads as zeros
    had_res = numerics.ATTR in metric.__dict__
    old_res = dict(metric.__dict__.get(numerics.ATTR) or {})
    poisoned = admission(inputs)
    run_update()
    selectable = all(
        isinstance(o, torch.Tensor)
        and isinstance(n := getattr(metric, k), torch.Tensor)
        and n.shape == o.shape
        and n.dtype == o.dtype
        for k, o in old.items()
    )
    from torchmetrics_tpu_torch.diag import sentinel, trace
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    count = ensure_count(metric)
    if selectable:
        for k, o in old.items():
            setattr(metric, k, torch.where(poisoned, o, getattr(metric, k)))
        new_res = metric.__dict__.get(numerics.ATTR)
        if new_res is not None:
            metric.__dict__[numerics.ATTR] = {
                k: torch.where(poisoned, old_res.get(k, torch.zeros_like(v)), v) for k, v in new_res.items()
            }
        metric.__dict__[ATTR] = count + poisoned.to(count.dtype)
        if sentinel.sentinel_enabled():
            flags = sentinel.ensure_flags(metric)
            metric.__dict__[sentinel.ATTR] = flags | poisoned.to(torch.int32) * sentinel.FLAG_INPUT_POISONED
        return
    with transfer_allowed("quarantine-check"):
        bad = bool(poisoned)
    if bad:
        for k, o in old.items():
            setattr(metric, k, o)
        if had_res:
            metric.__dict__[numerics.ATTR] = old_res
        else:
            metric.__dict__.pop(numerics.ATTR, None)
        metric.__dict__[ATTR] = count + 1
        if sentinel.sentinel_enabled():
            metric.__dict__[sentinel.ATTR] = sentinel.ensure_flags(metric) | sentinel.FLAG_INPUT_POISONED
        trace.record("update.quarantine", type(metric).__name__, count=1, path="eager")


def eager_apply(metric: Any, args: Sequence[Any], kwargs: Dict[str, Any]) -> None:
    """A raw update with quarantine parity: the ladder's eager rung."""
    if quarantine_enabled():
        eager_update(metric, lambda: metric._raw_update(*args, **kwargs), args, kwargs)
    else:
        metric._raw_update(*args, **kwargs)


# ------------------------------------------------------------------ fallback ladder

#: consecutive classified build failures of one signature before it is demoted like
#: a structural failure: a persistent resource failure must not pay a capture attempt
#: on every step
TRANSIENT_RETRY_BUDGET = 3


def transient_budget_exhausted(counts: Dict[Any, int], key: Any) -> bool:
    """Count one classified failure for ``key``; True once the budget is spent."""
    n = counts.get(key, 0) + 1
    counts[key] = n
    return n >= TRANSIENT_RETRY_BUDGET


def classify_and_demote(
    cache: Dict[Any, Any], fallback: Any, counts: Dict[Any, int], key: Any, exc: BaseException
) -> Optional[str]:
    """The first-step failure policy every engine cache shares.

    A structural failure (``classify_dispatch_error`` gives None) demotes ``key`` to
    ``fallback`` at once; a classified one leaves it retryable until the budget is
    spent, which demotes it too, with ``-budget`` added to the reason. Returns the
    classification, or None.
    """
    classified = classify_dispatch_error(exc)
    if classified is None:
        cache[key] = fallback
    elif transient_budget_exhausted(counts, key):
        cache[key] = fallback
        classified = f"{classified}-budget"
    return classified


def classify_dispatch_error(exc: BaseException) -> Optional[str]:
    """``"resource-exhausted"`` for an out-of-memory error (``torch.OutOfMemoryError``,
    "out of memory", ``MemoryError``), ``"xla-runtime"`` (the JAX package's name for a
    backend runtime failure) for another CUDA runtime error, None for a structural
    failure. A stream-capture error (an operation a CUDA graph cannot hold, or a
    capture it invalidated) is structural: retrying the capture cannot mend it."""
    name = type(exc).__name__
    text = f"{name}: {exc}".lower()
    if (
        isinstance(exc, (torch.OutOfMemoryError, MemoryError))
        or "out of memory" in text
        or "resource_exhausted" in text
        or "resource exhausted" in text
    ):
        return "resource-exhausted"
    if "captur" in text or "not permitted" in text:
        return None
    if isinstance(exc, RuntimeError) and ("cuda error" in text or "cudaerror" in text or "cuda runtime" in text):
        return "xla-runtime"
    return None


# ------------------------------------------------------------------ counter surfacing


def ensure_count(metric: Any) -> torch.Tensor:
    """The metric's device quarantine counter (``count_dtype``), zero on first use."""
    val = metric.__dict__.get(ATTR)
    if val is None:
        from torchmetrics_tpu_torch.engine.numerics import count_dtype

        val = torch.zeros((), dtype=count_dtype(), device=metric.device)
        metric.__dict__[ATTR] = val
        metric.__dict__["_quarantine_reported"] = 0
    _REGISTRY[id(metric)] = metric
    return val


def _stats_for(metric: Any):
    """The EngineStats block quarantine and compensation counts attribute to."""
    eng = metric.__dict__.get("_engine")
    if eng is not None:
        return eng.stats
    epoch = metric.__dict__.get("_epoch")
    if epoch is not None:
        return epoch.stats
    st = metric.__dict__.get("_txn_stats")
    if st is None:
        from torchmetrics_tpu_torch.engine.stats import EngineStats

        st = metric.__dict__["_txn_stats"] = EngineStats("txn:" + type(metric).__name__)
    return st


def read_quarantine(metric: Any) -> Dict[str, Any]:
    """The host read of the quarantine counter (``compute`` calls it): ``{"owner",
    "count"}``; growth since the last read lands in ``quarantined_batches``. Read on
    unsynced state for this rank's count, inside a sync window for the world's."""
    val = metric.__dict__.get(ATTR)
    if val is None:
        return {"owner": type(metric).__name__, "count": 0}
    from torchmetrics_tpu_torch.diag import lineage, trace
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    with transfer_allowed("quarantine-read"):
        total = int(val)
    reported = int(metric.__dict__.get("_quarantine_reported", 0))
    if total > reported:
        _stats_for(metric).quarantined_batches += total - reported
        trace.record("update.quarantine", type(metric).__name__, count=total - reported, total=total)
        # the value an observer reads does not cover the skipped batches
        lineage.note_excluded(type(metric).__name__, "quarantined", total - reported)
    if total != reported:
        metric.__dict__["_quarantine_reported"] = total
    return {"owner": type(metric).__name__, "count": total}


def mark_reported(metric: Any) -> None:
    """Align the reported watermark with the live counter, reporting nothing (``unsync``
    after a read inside the sync window, which already surfaced the world total)."""
    val = metric.__dict__.get(ATTR)
    if val is not None:
        from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

        with transfer_allowed("quarantine-read"):
            metric.__dict__["_quarantine_reported"] = int(val)


def quarantine_report() -> List[Dict[str, Any]]:
    """Every registered counter, read and summed per owner class, flagged owners first."""
    by_owner: Dict[str, Dict[str, Any]] = {}
    for metric in list(_REGISTRY.values()):
        row = read_quarantine(metric)
        slot = by_owner.setdefault(row["owner"], {"owner": row["owner"], "count": 0, "instances": 0})
        slot["count"] += row["count"]
        slot["instances"] += 1
    return sorted(by_owner.values(), key=lambda r: (r["count"] == 0, r["owner"]))


def reset_quarantine() -> None:
    """Zero every registered counter and clear the registry."""
    for metric in list(_REGISTRY.values()):
        val = metric.__dict__.get(ATTR)
        if val is not None:
            metric.__dict__[ATTR] = torch.zeros_like(val)
            metric.__dict__["_quarantine_reported"] = 0
    _REGISTRY.clear()
