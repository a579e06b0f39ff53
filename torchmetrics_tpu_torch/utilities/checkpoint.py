"""Save and restore metric states to and from ``.npz`` files (counterpart of
``torchmetrics_tpu/utilities/checkpoint.py``).

The port has no orbax, so it always takes the JAX package's ``.npz`` route, with the
same flat keys: a metric's ``state_dict`` keys (``"<member>.<state>"`` for a
collection), ``_update_count`` beside the states, and a list state as ``"<key>.__list__"``
(its length) plus ``"<key>.0"``, ``"<key>.1"``, .... A file one package wrote restores
into the other: a restore converts the arrays as ``interop.state_from_jax`` does
(integer states to int32, refusing values that do not fit), and ``load_state_dict``
gives each float state its metric's dtype.

Works for a ``Metric`` and for a ``MetricCollection``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch

from torchmetrics_tpu_torch.interop import state_from_jax


def _to_saveable(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``state_dict`` values as host arrays; a list state becomes a length tag plus items."""

    def host(x: Any) -> np.ndarray:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        if isinstance(value, list):
            out[f"{key}.__list__"] = np.asarray(len(value))
            for i, item in enumerate(value):
                out[f"{key}.{i}"] = host(item)
        else:
            out[key] = host(value)
    return out


def _from_saveable(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Undo ``_to_saveable``; the update counts come back as Python ints."""
    lists = {k[: -len(".__list__")]: int(v) for k, v in flat.items() if k.endswith(".__list__")}
    out: Dict[str, Any] = {key: [flat[f"{key}.{i}"] for i in range(length)] for key, length in lists.items()}
    for key, value in flat.items():
        if key.endswith(".__list__"):
            continue
        base = key.rsplit(".", 1)[0]
        if base in lists and key[len(base) :].lstrip(".").isdigit():
            continue
        out[key] = int(value) if key.rsplit(".", 1)[-1] == "_update_count" else value
    return out


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_metric_state(metric: Any, path: str) -> None:
    """Write every state of a metric (or collection) and its update counts to ``path``
    (``.npz`` is appended when missing).

    ``state_dict`` honours each state's ``persistent`` flag; a resume needs every
    state, so persistence is forced on while the states are read and each flag is
    put back afterwards.
    """
    saved_flags = [dict(m._persistent) for m in _metrics_of(metric)]
    try:
        metric.persistent(True)
        flat = _to_saveable(metric.state_dict())
    finally:
        for m, saved in zip(_metrics_of(metric), saved_flags):
            m._persistent.update(saved)
    np.savez(_npz_path(path), **flat)


def restore_metric_state(metric: Any, path: str) -> Any:
    """Restore states saved by ``save_metric_state`` (by either package) into ``metric``,
    in place, on its device; every cached ``compute`` value is dropped."""
    with np.load(_npz_path(path)) as npz:
        flat = dict(npz)
    metric.load_state_dict(state_from_jax(_from_saveable(flat), "cpu"))
    for m in _metrics_of(metric):
        m._computed = None
    return metric


def _metrics_of(metric: Any) -> Iterable[Any]:
    """The leaf metrics of a metric or a collection (the live objects, not the copies
    a collection hands out for its group views)."""
    from torchmetrics_tpu_torch.collections import MetricCollection  # the collection imports this package

    if isinstance(metric, MetricCollection):
        return list(metric.values(copy_state=False))
    return [metric]
