"""State footprint (counterpart of ``state_footprint`` in ``torchmetrics_tpu/diag/costs.py``).

A footprint counts the registered states and, as the JAX one does, the rider buffers
(the quarantine counter, the compensation residuals) under ``_riders``. The port adds
an ``engine`` note: the bytes its engines hold on the device beside the states, the
scan queue's input slots above all (``engine/scan.py``: ``k_bucket(K)`` slots of every
input per ring, so accuracy at 8192 x 1000 float32 logits and K=8 holds
8 x 8192 x 1000 x 4 bytes of logits per ring).

Left out against the JAX module: the executable-cost ledger (and with it the
``persist`` cache's bytes), the sentinel bitmask and the drift audit (``diag/sentinel.py``,
``diag/hist.py`` are not ported); the resilience layer holds no state here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def _leaf_bytes(value: Any) -> Tuple[int, List[Tuple[int, int]]]:
    """(total bytes, [(storage address, bytes)]) over a tensor or a list state."""
    total = 0
    buffers = []
    for leaf in value if isinstance(value, list) else [value]:
        n = leaf.nbytes if isinstance(leaf, torch.Tensor) else 0
        if n:
            total += n
            buffers.append((leaf.untyped_storage().data_ptr(), n))
    return total, buffers


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
        return {
            "owner": type(obj).__name__,
            "total_bytes": sum(per_state.values()),
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
        unique = 0
        for name in obj._modules:
            source = obj._modules[owner_of.get(name, name)]
            m_total = m_unique = 0
            values = [getattr(source, attr) for attr in source._defaults] + _rider_values(obj._modules[name])
            for value in values:
                total, buffers = _leaf_bytes(value)
                m_total += total
                for address, nbytes in buffers:
                    if address not in seen:
                        seen.add(address)
                        m_unique += nbytes
            per_metric[name] = m_total
            member_unique[name] = m_unique
            unique += m_unique
        nominal = sum(per_metric.values())
        out: Dict[str, Any] = {
            "owner": type(obj).__name__,
            "total_bytes": nominal,
            "unique_bytes": unique,
            "shared_bytes": nominal - unique,
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
