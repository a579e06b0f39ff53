"""The cost ledger and the state footprint (counterpart of ``torchmetrics_tpu/diag/costs.py``).

**The ledger.** The engines record one :class:`ExecutableCost` per built signature, keyed
by ``(owner, kind, signature)`` (``signature`` is the digest of the engine's cache key,
the one in the ``tm:<owner>:<kind>:<signature>`` attribution scope): a captured CUDA
graph on the card, its plain step on the CPU. Kinds are ``update`` and ``fused``
(``engine/compiled.py``), ``scan`` (``engine/scan.py``, one entry per ``kb`` graph),
``compute`` and ``sync-compute`` (``engine/epoch.py``). An entry holds the build's wall
ms (``compile_ms``: the guarded warm-up and, on the card, the capture), the capture's
own wall ms (``capture_ms``), the graph pool's bytes (``pool_bytes``: growth of the
CUDA allocator's reserved bytes around the capture; a later graph reusing the engine's
pool may add none) and the static ``static_input_bytes`` and ``state_bytes`` the graph
reads and writes. Where the JAX ledger reads XLA's ``cost_analysis`` /
``memory_analysis``, a CUDA graph reports nothing: ``flops``, ``bytes_accessed``,
``peak_bytes``, ``output_bytes``, ``temp_bytes`` and ``generated_code_bytes`` are
``None``, as the JAX module leaves them on a backend without the analyses, and
``analyses_ok`` is False. ``TORCHMETRICS_TPU_COSTS=0`` turns the ledger off.

**The footprint.** A footprint counts the registered states and, as the JAX one does, the rider buffers
(the quarantine counter, the compensation residuals) under ``_riders``. The port adds
an ``engine`` note: the bytes its engines hold on the device beside the states, the
scan queue's input slots above all (``engine/scan.py``: ``k_bucket(K)`` slots of every
input per ring, so accuracy at 8192 x 1000 float32 logits and K=8 holds
8 x 8192 x 1000 x 4 bytes of logits per ring).

Left out against the JAX module: ``aot_compile`` and the ``persist`` cache (the
port captures graphs and persists none), and the sentinel bitmask in the footprint.
"""

from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "ExecutableCost",
    "costs_enabled",
    "key_digest",
    "ledger_entries",
    "ledger_snapshot",
    "record_build",
    "reset_ledger",
    "set_costs_enabled",
    "state_footprint",
]

#: env knob: "0" disables ledger collection
COSTS_ENV_VAR = "TORCHMETRICS_TPU_COSTS"

_enabled_override: Optional[bool] = None


def costs_enabled() -> bool:
    """Whether engine builds record ledger entries (default: on)."""
    if _enabled_override is not None:
        return _enabled_override
    return os.environ.get(COSTS_ENV_VAR, "").strip() != "0"


def set_costs_enabled(value: Optional[bool]) -> None:
    """Force the ledger on/off process-wide; ``None`` restores the env/default."""
    global _enabled_override
    _enabled_override = value


class ExecutableCost:
    """One built signature's cost record (one per (owner, kind, signature)): the JAX
    fields, ``None`` where a CUDA graph reports nothing, and the capture's figures."""

    __slots__ = (
        "owner", "kind", "signature", "arg_leaves", "arg_bytes", "flops",
        "bytes_accessed", "peak_bytes", "argument_bytes", "output_bytes",
        "temp_bytes", "generated_code_bytes", "donation_savings_bytes",
        "compile_ms", "compiles", "cache_hits", "deserialize_ms",
        "time_to_first_dispatch_ms", "analyses_ok",
        "capture_ms", "pool_bytes", "static_input_bytes", "state_bytes",
    )

    def __init__(self, owner: str, kind: str, signature: str) -> None:
        self.owner = owner
        self.kind = kind  # update | fused | scan | compute | sync-compute
        self.signature = signature
        self.arg_leaves = 0
        self.arg_bytes = 0
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.peak_bytes: Optional[int] = None
        self.argument_bytes: Optional[int] = None
        self.output_bytes: Optional[int] = None
        self.temp_bytes: Optional[int] = None
        self.generated_code_bytes: Optional[int] = None
        self.donation_savings_bytes = 0  # a graph writes its state buffers in place: nothing donated
        self.compile_ms = 0.0  # build wall ms summed over builds (warm-up, plus capture on the card)
        self.compiles = 0
        self.cache_hits = 0  # the port loads no persisted graph
        self.deserialize_ms = 0.0
        self.time_to_first_dispatch_ms: Optional[float] = None
        self.analyses_ok = False
        self.capture_ms: Optional[float] = None  # None on the CPU: nothing is captured
        self.pool_bytes: Optional[int] = None
        self.static_input_bytes = 0
        self.state_bytes = 0

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


# (owner, kind, signature) -> ExecutableCost; snapshots sort deterministically
_LEDGER: "Dict[Tuple[str, str, str], ExecutableCost]" = {}


def key_digest(key: Any) -> str:
    """The 8-hex-digit crc32 of an engine cache key's ``repr``: the signature part of a
    ledger entry and of the attribution scope."""
    return format(zlib.crc32(repr(key).encode()) & 0xFFFFFFFF, "08x")


def _bytes_of(tensors: Any) -> Tuple[int, int]:
    leaves: List[torch.Tensor] = []
    for t in tensors:
        if isinstance(t, torch.Tensor):
            leaves.append(t)
    return len(leaves), sum(t.nbytes for t in leaves)


def record_build(
    owner: str,
    kind: str,
    signature: str,
    build_ms: float,
    inputs: Any = (),
    states: Any = (),
    capture_ms: Optional[float] = None,
    pool_bytes: Optional[int] = None,
) -> Optional[ExecutableCost]:
    """Land one built signature in the ledger (a rebuild of the same key accumulates).
    ``inputs`` and ``states`` are the static tensors the build reads and writes."""
    if not costs_enabled():
        return None
    entry = _LEDGER.get((owner, kind, signature))
    if entry is None:
        entry = _LEDGER[(owner, kind, signature)] = ExecutableCost(owner, kind, signature)
    n_in, in_bytes = _bytes_of(inputs)
    n_st, st_bytes = _bytes_of(states)
    entry.static_input_bytes = in_bytes
    entry.state_bytes = st_bytes
    entry.arg_leaves = n_in + n_st
    entry.arg_bytes = in_bytes + st_bytes
    entry.compiles += 1
    entry.compile_ms += build_ms
    entry.time_to_first_dispatch_ms = round(build_ms, 3)
    if capture_ms is not None:
        entry.capture_ms = round((entry.capture_ms or 0.0) + capture_ms, 3)
    if pool_bytes is not None:
        entry.pool_bytes = (entry.pool_bytes or 0) + int(pool_bytes)
    return entry


def ledger_entries() -> List[Dict[str, Any]]:
    """Every recorded entry, sorted by (owner, kind, signature)."""
    return [e.as_dict() for _, e in sorted(_LEDGER.items())]


def ledger_snapshot() -> Dict[str, Any]:
    """``{"executables": [...], "totals": {...}, "per_owner": {owner: totals}}``; the
    totals carry the JAX keys plus ``capture_ms`` and ``pool_bytes``."""
    entries = ledger_entries()

    def _totals(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
        return {
            "executables": len(rows),
            "flops": sum(r["flops"] or 0.0 for r in rows),
            "bytes_accessed": sum(r["bytes_accessed"] or 0.0 for r in rows),
            "peak_bytes_max": max((r["peak_bytes"] or 0 for r in rows), default=0),
            "compile_ms": round(sum(r["compile_ms"] for r in rows), 3),
            "compiles": sum(r["compiles"] for r in rows),
            "cache_hits": sum(r["cache_hits"] for r in rows),
            "deserialize_ms": round(sum(r["deserialize_ms"] for r in rows), 3),
            "donation_savings_bytes": sum(r["donation_savings_bytes"] for r in rows),
            "capture_ms": round(sum(r["capture_ms"] or 0.0 for r in rows), 3),
            "pool_bytes": sum(r["pool_bytes"] or 0 for r in rows),
        }

    per_owner: Dict[str, List[Dict[str, Any]]] = {}
    for row in entries:
        per_owner.setdefault(row["owner"], []).append(row)
    return {
        "executables": entries,
        "totals": _totals(entries),
        "per_owner": {owner: _totals(rows) for owner, rows in sorted(per_owner.items())},
    }


def reset_ledger() -> None:
    """Drop every entry (``reset_engine_stats`` calls this)."""
    _LEDGER.clear()


def _leaf_bytes(value: Any) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(total bytes, [(storage address, bytes, bytes on this rank)]) over a tensor or a
    list state. A sharded state (``parallel/sharding.py``) counts its whole value in
    bytes and its local block on this rank."""
    from torchmetrics_tpu_torch.parallel.sharding import local

    total = 0
    buffers = []
    for leaf in value if isinstance(value, list) else [value]:
        n = leaf.nbytes if isinstance(leaf, torch.Tensor) else 0
        if n:
            total += n
            block = local(leaf)
            buffers.append((block.untyped_storage().data_ptr(), n, block.nbytes))
    return total, buffers


def _leaf_device_bytes(value: Any) -> int:
    """Bytes this rank's device holds for a state: a sharded state's block (about
    ``nbytes / S``), a replicated one's whole value."""
    return sum(b[2] for b in _leaf_bytes(value)[1])


def _rider_values(metric: Any) -> list:
    """The rider tensors a metric holds beside its registered states."""
    values = []
    quarantine = metric.__dict__.get("_quarantined_count")
    if quarantine is not None:
        values.append(quarantine)
    residuals = metric.__dict__.get("_comp_residuals")
    if residuals:
        values.extend(residuals.values())
    return values


def _engine_note(engines: List[Any]) -> Dict[str, int]:
    """Device bytes the update engines hold beside the states: ``scan_slot_bytes`` (the
    scan queue's input slots, every ring) and ``scan_rings``."""
    slot_bytes = rings = 0
    for eng in engines:
        queue = getattr(eng, "_scan", None) if eng is not None else None
        if queue is not None:
            slot_bytes += queue.slot_bytes
            rings += sum(len(p.rings) for p in queue._plans.values() if hasattr(p, "rings"))
    return {"scan_slot_bytes": slot_bytes, "scan_rings": rings}


def state_footprint(obj: Any) -> Dict[str, Any]:
    """Bytes held by the states of a ``Metric`` or a ``MetricCollection``.

    For a metric: ``per_state`` and ``total_bytes`` of the registered states (a list
    state sums its elements). For a collection: each member's nominal bytes
    (``per_metric``, ``total_bytes``) and ``unique_bytes``, which counts once a buffer
    that compute-group views share with their owner (``shared_bytes`` is the overlap),
    with a ``groups`` entry per group of two or more members holding its state once.
    A view's states are read from its group's owner, so the walk changes nothing.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric
        >>> state_footprint(MeanMetric(device="cpu"))["total_bytes"]
        8
    """
    if hasattr(obj, "_defaults"):  # a Metric
        per_state = {attr: _leaf_bytes(getattr(obj, attr))[0] for attr in obj._defaults}
        riders = sum(_leaf_bytes(v)[0] for v in _rider_values(obj))
        if riders:
            per_state["_riders"] = riders
        # per_device_bytes == total_bytes for a replicated metric; a sharded state
        # costs its block (about 1/S of its bytes) on this rank's device
        values = [getattr(obj, attr) for attr in obj._defaults] + _rider_values(obj)
        return {
            "owner": type(obj).__name__,
            "total_bytes": sum(per_state.values()),
            "per_device_bytes": sum(_leaf_device_bytes(v) for v in values),
            "per_state": per_state,
            "engine": _engine_note([obj.__dict__.get("_engine")]),
        }
    if hasattr(obj, "_modules"):  # a MetricCollection
        groups = list((getattr(obj, "_groups", None) or {}).values())
        owner_of: Dict[str, str] = {}
        if obj._groups_checked:
            for group in groups:
                for view_name in group.names[1:]:
                    owner_of[view_name] = group.names[0]
        per_metric: Dict[str, int] = {}
        member_unique: Dict[str, int] = {}
        seen: set = set()
        unique = device_unique = 0
        for name in obj._modules:
            source = obj._modules[owner_of.get(name, name)]
            m_total = m_unique = 0
            values = [getattr(source, attr) for attr in source._defaults] + _rider_values(obj._modules[name])
            for value in values:
                total, buffers = _leaf_bytes(value)
                m_total += total
                for address, nbytes, local_bytes in buffers:
                    if address not in seen:
                        seen.add(address)
                        m_unique += nbytes
                        device_unique += local_bytes
            per_metric[name] = m_total
            member_unique[name] = m_unique
            unique += m_unique
        nominal = sum(per_metric.values())
        out: Dict[str, Any] = {
            "owner": type(obj).__name__,
            "total_bytes": nominal,
            "unique_bytes": unique,
            "shared_bytes": nominal - unique,
            "per_device_bytes": device_unique,
            "per_metric": per_metric,
            "engine": _engine_note(
                [obj.__dict__.get("_fused_engine")] + [m.__dict__.get("_engine") for m in obj._modules.values()]
            ),
        }
        shared_groups = [
            {"owner": g.owner, "members": len(g.names), "canonical_bytes": sum(member_unique[n] for n in g.names)}
            for g in groups
            if len(g.names) >= 2
        ]
        if shared_groups:
            out["groups"] = shared_groups
        return out
    raise TypeError(f"state_footprint expects a Metric or MetricCollection, got {type(obj).__name__}")
