"""In-graph health sentinels and the cross-rank divergence-audit knob (counterpart of
``torchmetrics_tpu/diag/sentinel.py``).

A NaN in a metric state is invisible until ``compute()`` returns garbage, and looking
for it with ``torch.isnan(state).any()`` and a Python ``if`` is a device-to-host read,
which the hot loop must not do. The sentinel keeps the check on the device:

- every sentinel-enabled metric carries one int32 0-d tensor (``metric._sentinel_flags``;
  ``SENTINEL_KEY`` in a compiled step's state dict, ``engine/statespec.py``) holding a
  sticky bitmask;
- the engines fold :func:`update_flags` into the step body (``engine/compiled.py``'s
  ``write_step``: the one-step graphs, the fused collection step and each step of a scan
  graph) and :func:`value_flags` into the cached compute (``engine/epoch.py``), so a
  check is a few reductions captured into the same CUDA graph as the update. Inside a
  graph the flags are a static buffer written in place, like the states;
- the packed sync (``parallel/packing.py``) folds the bitmask across ranks by bitwise
  OR over the gathered rows, so a flag raised on any rank survives the fold;
- the bitmask reaches the host only at :func:`read_sentinel`, inside
  ``transfer_allowed("sentinel-read")``.

As in the JAX package, the eager update path folds no state check: it sets only
``input_poisoned`` (``engine/txn.py``) and ``precision_loss`` (``engine/numerics.py``).

Bit layout (sticky: bits are only ever set until :func:`reset_sentinels` or
``Metric.reset``):

======================  ====  ====================================================
``nan``                 0x01  a float state contains NaN
``pos_inf``             0x02  a float state contains +Inf (skipped for states whose
                              registered default already holds +Inf, e.g. MinMetric)
``neg_inf``             0x04  a float state contains -Inf (same default exemption)
``overflow_suspect``    0x08  an integer state's magnitude crossed half its dtype
                              range: the next epochs may wrap
``negative_count``      0x10  a sum/mean-reduced integer state went negative
``input_poisoned``      0x20  a batch failed the quarantine admission check and was
                              skipped (``engine/txn.py``): the INPUT was poisoned,
                              the state stayed clean
``precision_loss``      0x40  an update's entire nonzero contribution landed below the
                              accumulator's ulp (``fl(acc + inc) == acc``,
                              ``engine/numerics.py``)
======================  ====  ====================================================

Enablement (first hit wins): :func:`sentinel_context` / :func:`set_sentinel_enabled`,
then ``TORCHMETRICS_TPU_SENTINEL`` (``"1"`` on, ``"0"``/unset off). Enable on every
rank: the bitmask joins the packed sync's buffers.

The divergence audit (:func:`audit_context` / ``TORCHMETRICS_TPU_AUDIT``) lives here
too: it piggybacks per-state value fingerprints on the packed sync's int32 metadata
gather and flags rank-divergent states a metric declares rank-invariant
(``Metric._rank_invariant_states``) before the fold hides them. :func:`value_fingerprint`
is the JAX digest: the crc32 of the float64-cast buffer (magnitudes for complex), with
the element count, so the same values give the same fingerprint in both packages.
"""

from __future__ import annotations

import os
import weakref
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Generator, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.engine.statespec import SENTINEL_KEY as STATE_KEY

__all__ = [
    "SENTINEL_BITS",
    "audit_context",
    "audit_enabled",
    "ensure_flags",
    "read_sentinel",
    "reset_sentinels",
    "sentinel_context",
    "sentinel_enabled",
    "sentinel_report",
    "set_audit_enabled",
    "set_sentinel_enabled",
    "update_flags",
    "value_fingerprint",
    "value_flags",
]

SENTINEL_ENV_VAR = "TORCHMETRICS_TPU_SENTINEL"
AUDIT_ENV_VAR = "TORCHMETRICS_TPU_AUDIT"

#: the attribute carrying the live bitmask on a metric instance
ATTR = "_sentinel_flags"

FLAG_NAN = 0x01
FLAG_POS_INF = 0x02
FLAG_NEG_INF = 0x04
FLAG_OVERFLOW = 0x08
FLAG_NEGATIVE_COUNT = 0x10
FLAG_INPUT_POISONED = 0x20
FLAG_PRECISION_LOSS = 0x40

SENTINEL_BITS = {
    "nan": FLAG_NAN,
    "pos_inf": FLAG_POS_INF,
    "neg_inf": FLAG_NEG_INF,
    "overflow_suspect": FLAG_OVERFLOW,
    "negative_count": FLAG_NEGATIVE_COUNT,
    "input_poisoned": FLAG_INPUT_POISONED,
    "precision_loss": FLAG_PRECISION_LOSS,
}

_enabled_override: Optional[bool] = None
_audit_override: Optional[bool] = None

# metrics carrying a bitmask, for process-wide reporting; keyed by id() (a metric's hash
# follows its state tensors) with weak values
_REGISTRY: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def sentinel_enabled() -> bool:
    """Whether the engines fold the health sentinel into their steps."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(SENTINEL_ENV_VAR, "").strip() == "1"


def set_sentinel_enabled(value: Optional[bool]) -> None:
    """Force sentinels on/off process-wide; ``None`` restores the env/default."""
    global _enabled_override
    _enabled_override = value


@contextmanager
def sentinel_context(enabled: bool = True) -> Generator[None, None, None]:
    """Scoped sentinel enablement. Toggling mid-stream builds the affected signatures
    once more (the rider changes the step's state dict)."""
    global _enabled_override
    prev = _enabled_override
    _enabled_override = enabled
    try:
        yield
    finally:
        _enabled_override = prev


def audit_enabled() -> bool:
    """Whether packed-sync plans piggyback the cross-rank divergence audit."""
    if _audit_override is not None:
        return _audit_override
    return os.environ.get(AUDIT_ENV_VAR, "").strip() == "1"


def set_audit_enabled(value: Optional[bool]) -> None:
    global _audit_override
    _audit_override = value


@contextmanager
def audit_context(enabled: bool = True) -> Generator[None, None, None]:
    """Scoped divergence-audit enablement. Enable on every rank: the audit entries extend
    the metadata gather, which must have the same layout world-wide."""
    global _audit_override
    prev = _audit_override
    _audit_override = enabled
    try:
        yield
    finally:
        _audit_override = prev


# ------------------------------------------------------------------ flags math


def ensure_flags(metric: Any) -> torch.Tensor:
    """The metric's bitmask, created (and its check plan cached) on first use.

    The one-time setup inspects the registered defaults to exempt states that hold
    ±Inf by design (MinMetric / MaxMetric); that reads host values, inside
    ``transfer_allowed("sentinel-setup")``, once per metric.
    """
    flags = metric.__dict__.get(ATTR)
    if flags is None:
        from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

        with transfer_allowed("sentinel-setup"):
            inf_ok = {}
            for name, default in metric._defaults.items():
                if isinstance(default, torch.Tensor) and default.is_floating_point():
                    inf_ok[name] = bool(torch.isinf(default).any())
                else:
                    inf_ok[name] = False
        metric.__dict__["_sentinel_inf_default"] = inf_ok
        flags = torch.zeros((), dtype=torch.int32, device=metric.device)
        metric.__dict__[ATTR] = flags
    _REGISTRY[id(metric)] = metric
    return flags


def _flag_if(cond: torch.Tensor, bit: int) -> torch.Tensor:
    """``bit`` where ``cond`` holds, else 0, as int32 (no host value enters the graph)."""
    return cond.to(torch.int32) * bit


def _flat(leaves: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """One flat tensor over same-dtype leaves (no copy for one leaf), or None when they
    hold no element (``any`` of nothing is False)."""
    leaves = [leaf for leaf in leaves if leaf.numel()]
    if not leaves:
        return None
    return leaves[0].reshape(-1) if len(leaves) == 1 else torch.cat([leaf.reshape(-1) for leaf in leaves])


def update_flags(prev: torch.Tensor, states: Dict[str, Any], metric: Any) -> torch.Tensor:
    """Fold health checks over the updated ``states`` into the sticky bitmask (device ops
    only, captured into the step's graph).

    The checks are the JAX ``update_flags``'s, batched: the leaves of one dtype (and one
    role) are flattened together and reduced once, an integer group by one ``aminmax``,
    so a metric's fold costs a few kernels whatever its number of states (any over a
    union is the OR of the anys, so the bits are the same).
    """
    from torchmetrics_tpu_torch.utilities.data import dim_zero_mean, dim_zero_sum

    inf_exempt = metric.__dict__.get("_sentinel_inf_default", {})
    # (kind, dtype, role) -> leaves; kind "f": float (role: inf-checked), "i": integer
    # (role: a sum/mean-reduced count, which must not go negative)
    groups: Dict[Tuple[str, torch.dtype, bool], List[torch.Tensor]] = {}
    flags = prev
    for name, value in states.items():
        for leaf in value if isinstance(value, list) else [value]:
            if not isinstance(leaf, torch.Tensor) or leaf.dtype == torch.bool:
                continue
            if leaf.is_complex():  # the real part's infinities, either part's NaN
                flags = flags | _flag_if(torch.isnan(leaf).any(), FLAG_NAN)
                if not inf_exempt.get(name, False):
                    flags = flags | _flag_if(torch.isposinf(leaf.real).any(), FLAG_POS_INF)
                    flags = flags | _flag_if(torch.isneginf(leaf.real).any(), FLAG_NEG_INF)
            elif leaf.is_floating_point():
                groups.setdefault(("f", leaf.dtype, not inf_exempt.get(name, False)), []).append(leaf)
            else:
                counted = leaf.dtype.is_signed and metric._reductions.get(name) in (dim_zero_sum, dim_zero_mean)
                groups.setdefault(("i", leaf.dtype, counted), []).append(leaf)
    for dtype in {d for kind, d, _ in groups if kind == "f"}:
        checked, exempt = groups.get(("f", dtype, True), []), groups.get(("f", dtype, False), [])
        every = _flat(checked + exempt)
        if every is not None:
            flags = flags | _flag_if(torch.isnan(every).any(), FLAG_NAN)
        inf = _flat(checked)
        if inf is not None:
            flags = flags | _flag_if(torch.isposinf(inf).any(), FLAG_POS_INF)
            flags = flags | _flag_if(torch.isneginf(inf).any(), FLAG_NEG_INF)
    for (kind, dtype, counted), leaves in groups.items():
        flat = _flat(leaves) if kind == "i" else None
        if flat is None:
            continue
        half = torch.iinfo(dtype).max // 2
        lo, hi = torch.aminmax(flat)
        if dtype.is_signed:
            flags = flags | _flag_if((hi > half) | (lo < -half), FLAG_OVERFLOW)
            if counted:
                flags = flags | _flag_if(lo < 0, FLAG_NEGATIVE_COUNT)
        else:
            flags = flags | _flag_if(hi > half, FLAG_OVERFLOW)
    return flags


def value_flags(prev: torch.Tensor, value: Any, metric: Any = None) -> torch.Tensor:
    """Fold NaN / ±Inf checks over a ``compute()`` result into the bitmask (device ops).

    A metric using the Inf-default idiom (MinMetric / MaxMetric: "no data yet" is ±Inf)
    keeps the exemption ``update_flags`` applies: only NaN is checked for it.
    """
    from torchmetrics_tpu_torch.utilities.data import apply_to_collection

    check_inf = not (metric is not None and any(metric.__dict__.get("_sentinel_inf_default", {}).values()))
    leaves: List[torch.Tensor] = []
    apply_to_collection(value, torch.Tensor, leaves.append)
    flags = prev
    for leaf in leaves:
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        flags = flags | _flag_if(torch.isnan(leaf).any(), FLAG_NAN)
        if check_inf:
            real = leaf.real if leaf.is_complex() else leaf
            flags = flags | _flag_if(torch.isposinf(real).any(), FLAG_POS_INF)
            flags = flags | _flag_if(torch.isneginf(real).any(), FLAG_NEG_INF)
    return flags


def value_fingerprint(value: torch.Tensor) -> Tuple[int, int, bool]:
    """``(crc32, element count, any nonzero)`` of a state for the divergence audit: the
    JAX package's digest of the float64-cast buffer (magnitudes for complex values).
    Reads the state on the host: call it inside ``transfer_allowed("sync-audit")``."""
    import numpy as np

    host = value.detach()
    if host.is_complex():
        host = host.abs()
    arr = np.ascontiguousarray(host.to("cpu", torch.float64).numpy())
    return zlib.crc32(arr.tobytes()) & 0x7FFFFFFF, int(arr.size) & 0x7FFFFFFF, bool(arr.any())


# ------------------------------------------------------------------ surfacing


def _bit_names(mask: int) -> List[str]:
    return [name for name, bit in SENTINEL_BITS.items() if mask & bit]


def read_sentinel(metric: Any) -> Dict[str, Any]:
    """The epoch-end host readout of a metric's sentinel, the sanctioned boundary.

    Returns ``{"owner", "flags", "bits"}``; ``flags == 0`` and ``bits == []`` when the
    metric is healthy or carries no sentinel.
    """
    value = metric.__dict__.get(ATTR)
    if value is None:
        return {"owner": type(metric).__name__, "flags": 0, "bits": []}
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    with transfer_allowed("sentinel-read"):
        mask = int(value)
    return {"owner": type(metric).__name__, "flags": mask, "bits": _bit_names(mask)}


def sentinel_report() -> List[Dict[str, Any]]:
    """Every registered sentinel, read and ORed per owner class (``instances`` counted),
    flagged owners first, then by name: one row per owner, byte-stable."""
    by_owner: Dict[str, Dict[str, Any]] = {}
    for metric in list(_REGISTRY.values()):
        row = read_sentinel(metric)
        slot = by_owner.setdefault(row["owner"], {"owner": row["owner"], "flags": 0, "instances": 0})
        slot["flags"] |= row["flags"]
        slot["instances"] += 1
    rows = [
        {"owner": o, "flags": s["flags"], "bits": _bit_names(s["flags"]), "instances": s["instances"]}
        for o, s in by_owner.items()
    ]
    rows.sort(key=lambda r: (r["flags"] == 0, r["owner"]))
    return rows


def reset_sentinels() -> None:
    """Zero every registered sentinel in place and clear the registry
    (``reset_engine_stats`` calls this)."""
    for metric in list(_REGISTRY.values()):
        flags = metric.__dict__.get(ATTR)
        if flags is not None:
            flags.zero_()
    _REGISTRY.clear()
