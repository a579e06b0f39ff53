"""State footprint (counterpart of ``state_footprint`` in ``torchmetrics_tpu/diag/costs.py``).

The JAX module's executable-cost ledger and its rider buffers (sentinel, quarantine
counter, compensation residuals) have no counterpart: the port has no riders, so a
footprint holds the registered states alone.
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
        return {"owner": type(obj).__name__, "total_bytes": sum(per_state.values()), "per_state": per_state}
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
            for attr in source._defaults:
                total, buffers = _leaf_bytes(getattr(source, attr))
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
