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

- **row additivity**: a state's ``StateSpec.row_additive`` holds the class's
  ``_engine_row_additive`` opt-in; the engine's shape buckets read it through
  ``row_additive``. ``state_additive`` reads
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

- **the registry**: ``add_state`` registers one frozen ``StateSpec`` per state
  (``build_spec`` + ``register_state_spec``): its fold, role, dtype policy, additivity,
  rank invariance and shard rule, derived once from ``dist_reduce_fx``, the class's
  declarations (``_engine_row_additive``, ``_engine_state_additive``,
  ``_rank_invariant_states``, ``_engine_shard_rules``) and the ``spec=`` overrides.
  ``spec_of`` reads it, and the readers above (``state_fold``, ``row_additive``,
  ``state_role``) read it too. A state that never went through ``add_state`` derives a
  spec from those conventions (``_derive_legacy``), cached, counted once in
  ``spec_fallbacks`` and recorded as ``spec.fallback``.
- **shard rules**: ``SHARD_RULES`` names the placements ``parallel/sharding.py`` makes
  real: ``replicate`` (the default), ``class_axis`` and ``row_sharded`` (dim 0 over the
  ``state`` mesh axis). ``resolve_shard_rule`` consults the partition-rule table first,
  then the named rule; an unknown name raises and lists the rules.
"""

from __future__ import annotations

import dataclasses
import os
from contextlib import contextmanager
from typing import Any, Callable, Dict, Generator, Optional, Tuple

from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine.stats import EngineStats
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

#: rider keys the bucketing pad-subtract identity passes through untouched
PAD_EXEMPT_KEYS = RIDER_KEYS


def _rule_replicate(spec: "StateSpec", value: Any = None) -> None:
    """State lives whole on every rank: no placement."""
    return None


def _rule_dim0(spec: "StateSpec", value: Any = None) -> Optional[Any]:
    """Partition the leading dim over the ``"state"`` mesh axis (or replicate)."""
    from torchmetrics_tpu_torch.parallel import sharding as _sharding

    return _sharding.partition_dim0(spec, value)


#: named shard rules (``parallel/sharding.py``): ``replicate`` keeps the state whole on
#: every rank; ``class_axis`` splits a per-class state's leading dim (the stat-scores
#: counters, confusion-matrix rows, the multilabel ``(L, 2, 2)`` stack) over the
#: ``"state"`` mesh axis, and ``row_sharded`` does the same for row-major matrices with
#: no class meaning (FID's covariance sums). Both degrade to replication, recorded,
#: with no mesh or an indivisible leading dim.
SHARD_RULES: Dict[str, Callable[["StateSpec", Any], Optional[Any]]] = {
    "replicate": _rule_replicate,
    "class_axis": _rule_dim0,
    "row_sharded": _rule_dim0,
}

#: the attribute the per-metric spec registry lives under
REGISTRY_ATTR = "_state_specs"

# spec fallbacks are a process-wide migration signal: one EngineStats joins the weak
# registry (the module global keeps it alive)
_STATS = EngineStats("statespec")

_cse_override: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Declarative specification of one registered state (frozen, picklable).

    ``fold``: ``sum`` / ``mean`` / ``max`` / ``min`` / ``cat`` / ``none`` / ``custom``
    (``fold_fn`` applies). ``role``: ``state``, or ``hh-grid`` / ``hh-ids`` /
    ``hh-counts`` (the joint heavy-hitter fold; ``hh`` = ``(grid attr, k, depth,
    width)`` on the ids) or ``ring-clock``. ``dtype_policy``: ``default`` or ``count``.
    ``row_additive`` / ``state_additive``: the bucketing and compensation
    eligibilities. ``pad_exempt``: riders. ``rank_invariant``: audited by the packed
    sync. ``shard_rule``: a name in ``SHARD_RULES``.
    """

    name: str
    fold: str = "none"
    fold_fn: Optional[Callable] = None
    role: str = "state"
    dtype_policy: str = "default"
    row_additive: bool = False
    state_additive: bool = False
    pad_exempt: bool = False
    rank_invariant: bool = False
    hh: Optional[Tuple[str, int, int, int]] = None
    shard_rule: str = "replicate"


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


def resolve_shard_rule(spec: StateSpec, value: Any = None, owner: str = "") -> Optional[Any]:
    """The placement a spec's shard rule gives ``value`` on the active mesh
    (``parallel/sharding.Partition``), or None: replicate, no mesh, or a degrade
    (recorded). The partition-rule table is consulted first (``owner/name``). An
    unknown rule raises and lists the registered rules."""
    try:
        rule = SHARD_RULES[spec.shard_rule]
    except KeyError:
        raise ValueError(
            f"state {spec.name!r} names unknown shard rule {spec.shard_rule!r} (registered rules: {sorted(SHARD_RULES)})"
        ) from None
    from torchmetrics_tpu_torch.parallel import sharding as _sharding

    match = _sharding.match_partition_rule(spec.name, owner)
    if match is not None:
        return _sharding.apply_partition_rule(spec, value, match[1])
    return rule(spec, value)


def build_spec(metric: Any, name: str, dist_reduce_fx: Any, overrides: Optional[Any] = None) -> StateSpec:
    """The spec ``add_state`` registers: defaults derived once from ``dist_reduce_fx``
    and the class's declarations, then ``overrides`` (a ready ``StateSpec`` or a dict of
    fields, the ``spec=`` roles). A renamed spec or an unknown shard rule raises at
    registration."""
    if isinstance(overrides, StateSpec):
        return dataclasses.replace(overrides, name=name)
    fold, fold_fn = fold_name(dist_reduce_fx)
    fields: Dict[str, Any] = {
        "name": name,
        "fold": fold,
        "fold_fn": fold_fn,
        "row_additive": bool(getattr(type(metric), "_engine_row_additive", False)),
        "state_additive": bool(getattr(type(metric), "_engine_state_additive", False)),
        "rank_invariant": name in (getattr(metric, "_rank_invariant_states", ()) or ()),
        "shard_rule": (getattr(metric, "_engine_shard_rules", None) or {}).get(name, "replicate"),
    }
    if overrides:
        unknown = set(overrides) - {f.name for f in dataclasses.fields(StateSpec)}
        if unknown:
            raise ValueError(f"unknown StateSpec field(s) for state {name!r}: {sorted(unknown)}")
        if "name" in overrides and overrides["name"] != name:
            raise ValueError(f"StateSpec override for state {name!r} must not rename it (got name={overrides['name']!r})")
        fields.update({k: v for k, v in overrides.items() if v is not None or k == "hh"})
        fields["name"] = name
    if fields["shard_rule"] not in SHARD_RULES:
        raise ValueError(
            f"state {name!r} names unknown shard rule {fields['shard_rule']!r} (registered rules: {sorted(SHARD_RULES)})"
        )
    return StateSpec(**fields)


def register_state_spec(metric: Any, spec: StateSpec) -> StateSpec:
    """Install ``spec`` in the metric's registry (``add_state`` calls this)."""
    registry = metric.__dict__.get(REGISTRY_ATTR)
    if registry is None:
        registry = {}
        object.__setattr__(metric, REGISTRY_ATTR, registry)
    registry[spec.name] = spec
    return spec


def _derive_legacy(metric: Any, name: str) -> StateSpec:
    """The spec of a state registered without ``add_state``: from ``_reductions`` and
    the class's declarations, the heavy-hitter pair from ``_hh_fold_info``."""
    spec = build_spec(metric, name, getattr(metric, "_reductions", {}).get(name))
    hh_info = getattr(metric, "_hh_fold_info", None)
    if hh_info is not None:
        if name == hh_info.get("cms"):
            spec = dataclasses.replace(spec, role="hh-grid")
        elif name == hh_info.get("ids"):
            hh = (hh_info["cms"], int(hh_info["k"]), int(hh_info["depth"]), int(hh_info["width"]))
            spec = dataclasses.replace(spec, role="hh-ids", hh=hh)
        elif name == hh_info.get("counts"):
            spec = dataclasses.replace(spec, role="hh-counts")
    return spec


def spec_of(metric: Any, name: str, consumer: str = "") -> StateSpec:
    """The registered ``StateSpec`` of ``metric.<name>``; a miss derives it
    (``_derive_legacy``), caches it, counts ``spec_fallbacks`` and records
    ``spec.fallback`` naming the consumer."""
    registry = metric.__dict__.get(REGISTRY_ATTR)
    if registry is not None:
        spec = registry.get(name)
        if spec is not None:
            return spec
    spec = register_state_spec(metric, _derive_legacy(metric, name))
    _STATS.spec_fallbacks += 1
    _diag.record("spec.fallback", type(metric).__name__, state=name, consumer=consumer, role=spec.role, fold=spec.fold)
    return spec


def specs_of(metric: Any, consumer: str = "") -> Dict[str, StateSpec]:
    """Every registered state's spec, in ``_reductions`` registration order."""
    return {name: spec_of(metric, name, consumer) for name in getattr(metric, "_reductions", {})}


def spec_fallback_count() -> int:
    """Process-wide count of derived (unregistered) specs."""
    return _STATS.spec_fallbacks


def state_fold(metric: Any, name: str) -> Tuple[str, Optional[Callable]]:
    """``(fold, fold_fn)`` of one registered state (its ``StateSpec``)."""
    spec = spec_of(metric, name, "fold")
    return spec.fold, spec.fold_fn


def state_additive(metric: Any) -> bool:
    """Whether the metric's update is additive in its states (``new = old + g(batch)``):
    the class's ``_engine_state_additive``, as its states' ``StateSpec``s hold it."""
    return any(spec.state_additive for spec in specs_of(metric, "compensation").values())


def row_additive(metric: Any, name: str) -> bool:
    """Whether state ``name`` is registered as row-additive (the class's
    ``_engine_row_additive``, in its ``StateSpec``)."""
    return spec_of(metric, name, "bucketing").row_additive


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
    """The checked copy of an ``add_state(spec=...)`` dict, which ``build_spec`` then
    folds into the registered ``StateSpec``: a ``role`` in ``ROLES``, an ``hh = (grid
    attr, k, depth, width)`` for ``hh-ids`` (and only there), and ``dtype_policy``
    ``"count"``. Anything else raises: an unknown role would silently fold as a plain
    state."""
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
    """The packed-sync role state ``name`` was registered with, or None (a plain state)."""
    role = spec_of(metric, name, "packed-sync").role
    return None if role == "state" else role
