"""Compensated accumulation (counterpart of ``torchmetrics_tpu/engine/numerics.py``).

A float32 sum over a long stream drifts: once ``|increment| < ulp(accumulator)`` an
update stops moving the state at all. With ``TORCHMETRICS_TPU_COMPENSATED=1`` (or
``compensated_context``), eligible float states (``comp_state_names``) accumulate
through Knuth's two-sum:

- the update body runs on ZEROED copies of the compensated states, so it leaves the
  pure batch contribution behind;
- ``value, err = two_sum(value, contribution + residual)`` folds the running residual
  back into every increment, and ``err``, exact, becomes the new residual.

The residual lives on the metric as ``_comp_residuals`` (``{state: tensor}``) between
steps; inside a compiled step it rides the state dict under
``statespec.COMPENSATION_KEY + state``, so the one-step graphs, the scan graphs
(``engine/scan.py``) and the eager path (``eager_update``) run the same few adds.
Two-sum is exact only if nothing reassociates ``(a + b) - a``: eager torch ops and
CUDA graph replays do not, and nothing here goes through ``torch.compile``.

``reanchor`` folds (value, residual) into a clean anchor at every ``compute``, the
anchored total is what ``state_dict`` writes, ``merge_state`` folds two
(value, residual) pairs by two-sum, and the packed sync (``parallel/packing.py``) folds
the ranks' pairs the same way.

``count_dtype`` is int64: the card has 64-bit integers without a flag, so the
quarantine counter never wraps. ``py_count`` keeps host counts Python ints.

With the sentinel on (``diag/sentinel.py``), a step whose nonzero contribution failed
to move its accumulator (``fl(acc + inc) == acc``) sets the sticky ``precision_loss``
bit, on the compiled and the eager path alike (masked by the quarantine admission, so a
rolled-back batch cannot stick it). With profiling on (``diag/profile.py``), every Nth
warm dispatch of a compensated metric reads its (value, residual) pair at
``transfer_allowed("drift-probe")`` (``maybe_drift_probe``): the worst relative drift of
the naive value from the float64 reference feeds the ``drift_ppb`` histogram and, past
``drift_rtol`` (``TORCHMETRICS_TPU_DRIFT_RTOL``, default 1e-5), a ``numerics.drift``
event and ``EngineStats.drift_flags``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.engine.statespec import COMPENSATION_KEY, state_additive, row_additive, state_fold
from torchmetrics_tpu_torch.parallel import sharding as _sharding
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "ATTR",
    "COMPENSATED_ENV_VAR",
    "DRIFT_RTOL_ENV_VAR",
    "STATE_KEY",
    "SYNC_RES_PREFIX",
    "anchored_value",
    "build_compensation",
    "comp_state_names",
    "compensated_context",
    "compensated_enabled",
    "compensation_active",
    "count_dtype",
    "drift_rtol",
    "eager_update",
    "ensure_residuals",
    "maybe_drift_probe",
    "py_count",
    "reanchor",
    "residual_key",
    "set_compensated",
    "set_drift_rtol",
    "set_residual",
    "two_sum",
]

COMPENSATED_ENV_VAR = "TORCHMETRICS_TPU_COMPENSATED"
DRIFT_RTOL_ENV_VAR = "TORCHMETRICS_TPU_DRIFT_RTOL"

#: default relative-drift threshold of the sampled audit: healthy compensation keeps the
#: residual sub-ulp, so measured drift stays below ~2**-24; the default fires only on
#: pathological states (a corrupt restore, injected state)
DEFAULT_DRIFT_RTOL = 1e-5

#: the rider key prefix of a residual inside a compiled step's state dict
STATE_KEY = COMPENSATION_KEY
#: the attribute carrying the live residual dict ({state attr: residual tensor})
ATTR = "_comp_residuals"
#: packed-sync fold output keys carrying a state's post-fold residual
SYNC_RES_PREFIX = "__comp_res__::"

_enabled_override: Optional[bool] = None
_rtol_override: Optional[float] = None


# ------------------------------------------------------------------ policy


def compensated_enabled() -> bool:
    """Whether eligible updates accumulate through the compensated two-sum.

    An unrecognized env value raises: a typo must not silently disable the protection
    it was set to enable.
    """
    if _enabled_override is not None:
        return _enabled_override
    raw = os.environ.get(COMPENSATED_ENV_VAR, "").strip().lower()
    if raw in ("", "0", "off"):
        return False
    if raw in ("1", "on"):
        return True
    raise TorchMetricsUserError(f"{COMPENSATED_ENV_VAR} must be '0'/'off' or '1'/'on' (got {raw!r})")


def set_compensated(value: Optional[bool]) -> None:
    """Force compensation on/off process-wide; ``None`` restores env/default."""
    global _enabled_override
    _enabled_override = value


@contextmanager
def compensated_context(enabled: bool = True) -> Generator[None, None, None]:
    """Scoped compensation enablement. Toggling mid-stream builds the affected
    signatures once more (the residual joins the step's state); enable it on every
    rank of a world or on none."""
    global _enabled_override
    prev = _enabled_override
    _enabled_override = enabled
    try:
        yield
    finally:
        _enabled_override = prev


def drift_rtol() -> float:
    """The relative-drift threshold past which the sampled audit flags; an unparseable
    env value raises."""
    if _rtol_override is not None:
        return _rtol_override
    raw = os.environ.get(DRIFT_RTOL_ENV_VAR, "").strip()
    if raw:
        try:
            return float(raw)
        except ValueError:
            raise TorchMetricsUserError(f"{DRIFT_RTOL_ENV_VAR} must be a float (got {raw!r})") from None
    return DEFAULT_DRIFT_RTOL


def set_drift_rtol(value: Optional[float]) -> None:
    """Override the drift threshold; ``None`` restores env/default."""
    global _rtol_override
    _rtol_override = None if value is None else float(value)


# ------------------------------------------------------------------ widening


def count_dtype() -> torch.dtype:
    """The dtype device-side counters accumulate in: int64."""
    return torch.int64


def py_count(value: Any) -> int:
    """A count as a Python int (arbitrary precision) before any additive fold: a
    numpy ``int32`` count wraps silently near 2**31."""
    return int(value)


# ------------------------------------------------------------------ two-sum


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's branch-free two-sum: ``s = fl(a + b)`` and the exact error term, for any
    ``(a, b)``; six elementwise operations."""
    s = a + b
    bp = s - a
    ap = s - bp
    return s, (a - ap) + (b - bp)


def anchored_value(value: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """The re-anchored accumulator ``fl(value + residual)`` (a read-only fold)."""
    return two_sum(value, residual)[0]


def residual_key(attr: str) -> str:
    """The step-state key of ``attr``'s residual."""
    return STATE_KEY + attr


# ------------------------------------------------------------------ eligibility


def comp_state_names(metric: Any) -> Tuple[str, ...]:
    """The states of ``metric`` the compensated two-sum applies to.

    A pure function of the metric's definition, so every rank resolves the same set:
    the update is declared additive (``_engine_state_additive`` on the aggregators,
    or the bucketing family's row additivity), the state folds with ``sum`` or
    ``mean``, and its registered default is a floating tensor.
    """
    names = []
    for attr in getattr(metric, "_reductions", {}):
        if state_fold(metric, attr)[0] not in ("sum", "mean"):
            continue
        if not (state_additive(metric) or row_additive(metric, attr)):
            continue
        default = metric._defaults[attr]
        if isinstance(default, torch.Tensor) and default.is_floating_point():
            names.append(attr)
    return tuple(names)


def compensation_active(metric: Any) -> bool:
    """Whether this metric's updates ride the compensated path right now."""
    return compensated_enabled() and bool(comp_state_names(metric))


def ensure_residuals(metric: Any) -> Dict[str, torch.Tensor]:
    """The metric's residual dict, created (zeros) on first use."""
    res = metric.__dict__.get(ATTR)
    if res is None:
        # a sharded state's residual is the local block of its value (parallel/sharding.py)
        res = {k: torch.zeros_like(_sharding.local(getattr(metric, k))) for k in comp_state_names(metric)}
        metric.__dict__[ATTR] = res
    return res


def set_residual(metric: Any, attr: str, value: torch.Tensor) -> None:
    """Install one state's residual (the packed-sync fold's output)."""
    res = dict(metric.__dict__.get(ATTR) or {})
    res[attr] = value
    metric.__dict__[ATTR] = res


# ------------------------------------------------------------------ the step transform


def build_compensation(names: Sequence[str]) -> Callable[[Dict[str, Any], Dict[str, Any]], Tuple[Dict[str, Any], torch.Tensor]]:
    """The step's ``(old, result) -> (result, absorbed)`` recomposition.

    ``result``'s compensated entries hold the pure batch contribution (the update
    body ran on zeroed copies of those states; pad rows are already subtracted from
    it). Each folds ``contribution + residual`` into the old value by ``two_sum`` and
    carries the exact error as the new residual under ``residual_key``. ``absorbed`` is
    a 0-d bool: some nonzero contribution failed to move its accumulator (the
    sentinel's ``precision_loss`` bit).
    """
    names = tuple(names)

    def comp(old: Dict[str, Any], result: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        out = dict(result)
        absorbed = None
        for k in names:
            rk = residual_key(k)
            out[k], out[rk] = two_sum(old[k], result[k] + old[rk])
            lost = ((result[k] != 0) & (out[k] == old[k])).any()
            absorbed = lost if absorbed is None else absorbed | lost
        return out, absorbed

    return comp


# ------------------------------------------------------------------ eager parity


def eager_update(metric: Any, run_update: Callable[[], None]) -> None:
    """The compensated eager update: the same zero-state trick and recomposition as
    the compiled step, as a few eager ops (no host transfer, one run of the body)."""
    names = comp_state_names(metric)
    residual = ensure_residuals(metric)
    old = {k: getattr(metric, k) for k in names}
    for k in names:
        setattr(metric, k, torch.zeros_like(old[k]))
    try:
        run_update()
    except BaseException:
        for k, v in old.items():  # a raising update must not leave zeroed state
            setattr(metric, k, v)
        raise
    new_res = dict(residual)
    absorbed = None
    for k in names:
        b = getattr(metric, k)  # the pure batch contribution
        s, err = two_sum(old[k], b + residual[k])
        setattr(metric, k, s)
        new_res[k] = err
        lost = ((b != 0) & (s == old[k])).any()
        absorbed = lost if absorbed is None else absorbed | lost
    metric.__dict__[ATTR] = new_res
    if absorbed is not None:
        from torchmetrics_tpu_torch.diag import sentinel

        if sentinel.sentinel_enabled():
            flags = sentinel.ensure_flags(metric)
            metric.__dict__[sentinel.ATTR] = flags | absorbed.to(torch.int32) * sentinel.FLAG_PRECISION_LOSS
    _stats_for(metric).compensated_steps += 1


def _stats_for(metric: Any):
    from torchmetrics_tpu_torch.engine import txn

    return txn._stats_for(metric)


# ------------------------------------------------------------------ re-anchoring


def reanchor(metric: Any) -> bool:
    """Fold (value, residual) into a clean anchor: the epoch-boundary fold.

    Device ops only: each compensated value absorbs its residual through one two-sum
    and the residual keeps the sub-ulp remainder. Returns True when something was
    folded. The residuals are new tensors: an engine's static buffer is never
    rebound here, the next step copies the new values in.
    """
    res = metric.__dict__.get(ATTR)
    if not res:
        return False
    new_res = {}
    for k, r in res.items():
        v = getattr(metric, k, None)
        if not isinstance(v, torch.Tensor) or v.shape != r.shape:
            new_res[k] = r  # the state moved under its residual (mid-restore)
            continue
        s, rem = two_sum(v, r)
        setattr(metric, k, s)
        new_res[k] = rem
    metric.__dict__[ATTR] = new_res
    _stats_for(metric).reanchors += 1
    from torchmetrics_tpu_torch.diag import trace

    trace.record("numerics.reanchor", type(metric).__name__, states=len(new_res))
    return True


# ------------------------------------------------------------------ drift audit


def maybe_drift_probe(metric: Any, stats: Any, owner: Optional[str] = None) -> Optional[float]:
    """The sampled precision-drift audit: every Nth warm dispatch under an active
    profile (``diag/profile.probe_due``), the (value, residual) pair is read inside
    ``transfer_allowed("drift-probe")`` and folded into a float64 reference on the host;
    the worst relative drift of the naive value goes to the ``drift_ppb`` histogram (in
    parts per billion), and past ``drift_rtol`` to a ``numerics.drift`` event and
    ``stats.drift_flags``. Unsampled steps are untouched. ``owner`` keeps each fused
    member on its own cadence."""
    res = metric.__dict__.get(ATTR)
    if not res:
        return None
    from torchmetrics_tpu_torch.diag import hist, profile, trace
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    owner = owner or stats.owner
    if not profile.probe_due(owner, "drift"):
        return None
    import numpy as np

    worst = 0.0
    with transfer_allowed("drift-probe"):
        for k, r in res.items():
            value = _sharding.local(getattr(metric, k)).detach().to("cpu", torch.float64).numpy()
            reference = value + r.detach().to("cpu", torch.float64).numpy()
            denom = np.maximum(np.abs(reference), np.finfo(np.float64).tiny)
            rel = float(np.max(np.abs(reference - value) / denom)) if value.size else 0.0
            if np.isnan(rel):
                rel = float("inf")  # a NaN in (value, residual) is infinite drift
            worst = max(worst, rel)
    stats.drift_probes += 1
    hist.observe(owner, "update", "drift_ppb", worst * 1e9)
    rtol = drift_rtol()
    if worst > rtol:
        stats.drift_flags += 1
        trace.record("numerics.drift", owner, rel=round(worst, 12), rtol=rtol)
    return worst
