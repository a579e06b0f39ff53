"""Fold semantics and reduction signatures (counterpart of part of ``torchmetrics_tpu/engine/statespec.py``).

Two things the collection and the packed sync read:

- **fold semantics**: ``fold_name`` maps a state's resolved ``dist_reduce_fx`` to
  ``sum`` / ``mean`` / ``max`` / ``min`` / ``cat`` / ``none`` / ``custom``;
  ``state_fold`` derives it for one registered state, as the JAX package's
  per-state derivation from ``_reductions`` does.
- **cross-metric common-subexpression fusion (CSE)**: metrics whose state-producing
  reduction is provably identical (the stat-scores family with matching
  ``num_classes`` / ``top_k`` / ``ignore_index``, confusion matrices with matching
  shape knobs) declare a ``reduction_signature``, and ``MetricCollection`` merges
  them into one compute group when it is built. ``TORCHMETRICS_TPU_CSE=0`` turns
  that off (back to the first-step value-equality discovery); an unknown value
  raises.

- **row additivity**: ``stamp_row_additive`` records, when a state is registered, the
  class's ``_engine_row_additive`` opt-in (the JAX package's ``StateSpec.row_additive``);
  the engine's shape buckets read it through ``row_additive``. ``state_additive`` reads
  the scalar aggregators' ``_engine_state_additive`` (``new = old + g(batch)``), which
  the compensated accumulation (``engine/numerics.py``) needs.
- **rider keys**: the reserved state keys under which the health sentinel
  (``diag/sentinel.py``), the quarantine counter and the compensation residuals ride a
  compiled step (``RIDER_KEYS``). The pad-subtract identity never reaches them: the
  update body returns the registered states alone, and the riders fold after it
  (``engine/compiled.py``'s ``write_step``).

- **serving roles**: ``add_state(spec=...)`` takes the roles ``serve/`` declares
  (``validate_role_spec``): ``hh-grid`` (a count-min grid), ``hh-ids`` with its
  ``hh = (grid attr, k, depth, width)`` and ``hh-counts`` (the top-k pair the packed
  plan folds jointly against the merged grid), ``ring-clock``, and
  ``dtype_policy="count"``. ``state_role`` reads a registered state's role.

The JAX package's ``StateSpec`` registry and its shard rules have no counterpart yet.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, Optional, Tuple

from torchmetrics_tpu_torch.utilities.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

CSE_ENV_VAR = "TORCHMETRICS_TPU_CSE"

#: the reserved keys the riders take in a compiled step's state dict. A compensated
#: state ``x`` rides its residual as ``COMPENSATION_KEY + x``.
SENTINEL_KEY = "__sentinel__"
QUARANTINE_KEY = "__quarantine__"
COMPENSATION_KEY = "__compensation__"

#: the riders' own keys (a residual key starts with ``COMPENSATION_KEY``)
RIDER_KEYS = frozenset({SENTINEL_KEY, QUARANTINE_KEY, COMPENSATION_KEY})

_FOLD_BY_FN = {
    dim_zero_sum: "sum",
    dim_zero_mean: "mean",
    dim_zero_max: "max",
    dim_zero_min: "min",
    dim_zero_cat: "cat",
}

_cse_override: Optional[bool] = None


def fold_name(dist_reduce_fx: Any) -> Tuple[str, Optional[Callable]]:
    """Canonical ``(fold, fold_fn)`` for a resolved ``dist_reduce_fx`` value."""
    name = _FOLD_BY_FN.get(dist_reduce_fx)
    if name is not None:
        return name, None
    if dist_reduce_fx is None:
        return "none", None
    if callable(dist_reduce_fx):
        return "custom", dist_reduce_fx
    raise ValueError(f"unresolvable dist_reduce_fx {dist_reduce_fx!r}")


def state_fold(metric: Any, name: str) -> Tuple[str, Optional[Callable]]:
    """``(fold, fold_fn)`` of one registered state, from the metric's ``_reductions``."""
    return fold_name(metric._reductions.get(name))


def stamp_row_additive(metric: Any, name: str) -> None:
    """Record at registration whether state ``name`` is additive over batch rows: the
    class declares it once with ``_engine_row_additive = True``."""
    metric._row_additive[name] = bool(getattr(type(metric), "_engine_row_additive", False))


def state_additive(metric: Any) -> bool:
    """Whether the class declares its update additive in its states
    (``_engine_state_additive``: ``new = old + g(batch)``)."""
    return bool(getattr(type(metric), "_engine_state_additive", False))


def row_additive(metric: Any, name: str) -> bool:
    """Whether state ``name`` was registered as row-additive (``stamp_row_additive``)."""
    return bool(getattr(metric, "_row_additive", {}).get(name, False))


def cse_enabled() -> bool:
    """Whether signature-based cross-metric fusion drives group discovery.

    ``TORCHMETRICS_TPU_CSE=0|off`` reverts ``MetricCollection`` to the first-step
    value-equality discovery; an unrecognized value raises, so a typo cannot change
    what fuses.
    """
    if _cse_override is not None:
        return _cse_override
    raw = os.environ.get(CSE_ENV_VAR, "").strip().lower()
    if raw in ("", "1", "on"):
        return True
    if raw in ("0", "off"):
        return False
    raise TorchMetricsUserError(f"{CSE_ENV_VAR} must be '0'/'off' or '1'/'on' (got {raw!r})")


def set_cse(value: Optional[bool]) -> None:
    """Force CSE discovery on or off process-wide; ``None`` restores the env/default."""
    global _cse_override
    _cse_override = value


@contextmanager
def cse_context(enabled: bool = True) -> Generator[None, None, None]:
    """Scoped CSE enablement. It affects group discovery, which runs when a collection
    is built or takes its first step: toggling does not regroup an existing collection."""
    global _cse_override
    prev = _cse_override
    _cse_override = enabled
    try:
        yield
    finally:
        _cse_override = prev


def update_family(metric: Any) -> Tuple[str, str]:
    """Identity of a metric's state-producing update body for CSE signatures.

    Keyed on the class's actual ``update`` function (module + qualname): metrics that
    inherit a base's update verbatim (accuracy over stat scores) share a family, and a
    subclass that overrides ``update`` breaks signature equality with no declaration
    to forget.
    """
    fn = type(metric).update
    return (fn.__module__, fn.__qualname__)


def reduction_signature(metric: Any) -> Optional[Tuple]:
    """The metric's state-producing-reduction signature, or ``None`` (no declaration).

    Two metrics with equal signatures run identical ``update`` bodies onto identically
    shaped, identically named states. A signature is a pure function of the metric's
    definition, so two metrics whose knobs differ can never merge by a first-batch
    value coincidence (e.g. differing ``ignore_index`` with no ignored label in the
    first batch).
    """
    fn = getattr(metric, "_cse_signature", None)
    if fn is None:
        return None
    sig = fn()
    if sig is None:
        return None
    # the registered state layout (names in order) joins the key, so a subclass that
    # adds a state can never collide with its parent's signature
    return (*sig, tuple(getattr(metric, "_reductions", {})))


#: the packed-sync roles a ``spec`` may declare (``serve/``'s states)
ROLES = frozenset({"hh-grid", "hh-ids", "hh-counts", "ring-clock"})
_SPEC_KEYS = frozenset({"role", "hh", "dtype_policy"})


def validate_role_spec(name: str, spec: Any) -> Dict[str, Any]:
    """The checked copy of an ``add_state(spec=...)`` dict: a ``role`` in ``ROLES``, an
    ``hh = (grid attr, k, depth, width)`` for ``hh-ids`` (and only there), and
    ``dtype_policy`` ``"count"``. Anything else raises: an unknown role would silently
    fold as a plain state."""
    if not isinstance(spec, dict) or not set(spec) <= _SPEC_KEYS:
        raise ValueError(f"state {name!r}: `spec` must be a dict with keys among {sorted(_SPEC_KEYS)}, got {spec!r}")
    role = spec.get("role")
    if role is not None and role not in ROLES:
        raise ValueError(f"state {name!r}: unknown role {role!r}; expected one of {sorted(ROLES)}")
    hh = spec.get("hh")
    if (role == "hh-ids") != (hh is not None):
        raise ValueError(f"state {name!r}: `hh` = (grid, k, depth, width) goes with role 'hh-ids' and only there")
    if hh is not None:
        if not (isinstance(hh, tuple) and len(hh) == 4 and isinstance(hh[0], str) and all(isinstance(v, int) for v in hh[1:])):
            raise ValueError(f"state {name!r}: `hh` must be (grid attr, k, depth, width), got {hh!r}")
    policy = spec.get("dtype_policy")
    if policy is not None and policy != "count":
        raise ValueError(f"state {name!r}: `dtype_policy` must be 'count', got {policy!r}")
    return dict(spec)


def state_role(metric: Any, name: str) -> Optional[str]:
    """The packed-sync role state ``name`` was registered with, or None."""
    return (getattr(metric, "_state_roles", None) or {}).get(name, {}).get("role")
