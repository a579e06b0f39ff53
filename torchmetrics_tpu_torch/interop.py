"""Carry metric state from the JAX package into the port.

``state_from_jax`` converts what ``torchmetrics_tpu``'s ``Metric.state_dict()`` returns
(numpy arrays, lists of them, and the ``_update_count`` int) into what the port's
``Metric.load_state_dict`` takes, so an evaluation started on the TPU can finish on the
GPU; ``collection_state_from_jax`` does the same for a ``MetricCollection.state_dict()``
(flat ``"<member>.<state>"`` keys), member by member. Integer states are pinned to
int32, the counters' dtype (JAX's 64-bit mode widens them to int64 when they fold); a
value that does not fit int32 raises instead of wrapping. Float states keep their
width here, and the port's ``load_state_dict`` casts each float state to the dtype of
its registered default: float32, or what ``set_dtype`` chose. A string in a list state
(the raw sentences of BERTScore and InfoLM, which JAX's ``state_dict`` gives as 0-d
``<U`` arrays) stays a Python ``str``.

Given the port metric (``metric=`` / ``collection=``), an integer state takes the
dtype of that metric's registered default instead: the serving states (``serve/``'s
rings' clocks, tenant tables, heavy-hitter grids and top-k pairs) are int64 in the
port, and their ids may pass ``2**31``; a value that does not fit the default's dtype
raises as well. Float states such as the KLL compactors keep
their ``+inf`` padding as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

def _is_text(value: Any) -> bool:
    """A string entry: ``str``, numpy ``str_`` or a 0-d ``<U`` array."""
    return isinstance(value, str) or (isinstance(value, np.ndarray) and value.dtype.kind == "U" and value.ndim == 0)


def _entry(value: Any, device: torch.device) -> Union[torch.Tensor, str]:
    """One element of a list state: a raw sentence stays a Python ``str``."""
    return str(value) if _is_text(value) else _tensor(value, device)


def _int_dtype(metric: Any, key: str) -> Optional[torch.dtype]:
    """The integer dtype of ``metric``'s registered default for state ``key``, or None."""
    default = getattr(metric, "_defaults", {}).get(key) if metric is not None else None
    if isinstance(default, torch.Tensor) and not default.is_floating_point() and default.dtype != torch.bool:
        return default.dtype
    return None


def _tensor(value: Any, device: torch.device, int_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    arr = np.array(value)  # a copy: a JAX array's host view is read-only
    if arr.dtype.kind in "iu":
        int_dtype = int_dtype or torch.int32
        info = torch.iinfo(int_dtype)
        if arr.size and (arr.min() < info.min or arr.max() > info.max):
            raise ValueError(f"integer state with values in [{arr.min()}, {arr.max()}] does not fit {int_dtype}")
        arr = arr.astype(torch.empty(0, dtype=int_dtype).numpy().dtype)
    return torch.as_tensor(arr, device=device)


def state_from_jax(
    state_dict: Dict[str, Any], device: Union[str, torch.device], metric: Any = None
) -> Dict[str, Union[torch.Tensor, list, int]]:
    """The port's state dict for a JAX ``Metric.state_dict()`` (keys kept as they are).
    With ``metric``, integer states take its defaults' dtypes."""
    return _states_from_jax(state_dict, torch.device(device), metric, "")


def _states_from_jax(
    state_dict: Dict[str, Any], device: torch.device, metric: Any, prefix: str
) -> Dict[str, Union[torch.Tensor, list, int]]:
    """``state_from_jax`` for keys that carry ``prefix`` (a collection member's)."""
    out: Dict[str, Union[torch.Tensor, list, int]] = {}
    for key, value in state_dict.items():
        if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
            out[key] = int(value)
        elif isinstance(value, (list, tuple)):
            out[key] = [_entry(v, device) for v in value]
        else:
            out[key] = _tensor(value, device, _int_dtype(metric, key[len(prefix) :]))
    return out


def collection_state_from_jax(
    state_dict: Dict[str, Any], device: Union[str, torch.device], collection: Any = None
) -> Dict[str, Union[torch.Tensor, list, int]]:
    """The port's ``MetricCollection`` state dict for a JAX ``MetricCollection.state_dict()``.

    Keys are ``"<member>.<state>"`` (``"<member>._update_count"`` included); each
    member's entries convert with ``state_from_jax`` (against the member of
    ``collection`` when given) and keep their keys.
    """
    members: Dict[str, Dict[str, Any]] = {}
    for key, value in state_dict.items():
        member, sep, _ = key.partition(".")
        if not sep:
            raise ValueError(f"collection state key {key!r} is not of the form '<member>.<state>'")
        members.setdefault(member, {})[key] = value
    out: Dict[str, Union[torch.Tensor, list, int]] = {}
    for member, entries in members.items():
        metric = collection[member] if collection is not None and member in collection else None
        out.update(_states_from_jax(entries, torch.device(device), metric, member + "."))
    return out
