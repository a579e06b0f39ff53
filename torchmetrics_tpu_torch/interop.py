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
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

_INT32 = np.iinfo(np.int32)


def _is_text(value: Any) -> bool:
    """A string entry: ``str``, numpy ``str_`` or a 0-d ``<U`` array."""
    return isinstance(value, str) or (isinstance(value, np.ndarray) and value.dtype.kind == "U" and value.ndim == 0)


def _entry(value: Any, device: torch.device) -> Union[torch.Tensor, str]:
    """One element of a list state: a raw sentence stays a Python ``str``."""
    return str(value) if _is_text(value) else _tensor(value, device)


def _tensor(value: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(value)  # a copy: a JAX array's host view is read-only
    if arr.dtype.kind in "iu":
        if arr.size and (arr.min() < _INT32.min or arr.max() > _INT32.max):
            raise ValueError(f"integer state with values in [{arr.min()}, {arr.max()}] does not fit int32")
        arr = arr.astype(np.int32)
    return torch.as_tensor(arr, device=device)


def state_from_jax(
    state_dict: Dict[str, Any], device: Union[str, torch.device]
) -> Dict[str, Union[torch.Tensor, list, int]]:
    """The port's state dict for a JAX ``Metric.state_dict()`` (keys kept as they are)."""
    device = torch.device(device)
    out: Dict[str, Union[torch.Tensor, list, int]] = {}
    for key, value in state_dict.items():
        if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
            out[key] = int(value)
        elif isinstance(value, (list, tuple)):
            out[key] = [_entry(v, device) for v in value]
        else:
            out[key] = _tensor(value, device)
    return out


def collection_state_from_jax(
    state_dict: Dict[str, Any], device: Union[str, torch.device]
) -> Dict[str, Union[torch.Tensor, list, int]]:
    """The port's ``MetricCollection`` state dict for a JAX ``MetricCollection.state_dict()``.

    Keys are ``"<member>.<state>"`` (``"<member>._update_count"`` included); each
    member's entries convert with ``state_from_jax`` and keep their keys.
    """
    members: Dict[str, Dict[str, Any]] = {}
    for key, value in state_dict.items():
        member, sep, _ = key.partition(".")
        if not sep:
            raise ValueError(f"collection state key {key!r} is not of the form '<member>.<state>'")
        members.setdefault(member, {})[key] = value
    out: Dict[str, Union[torch.Tensor, list, int]] = {}
    for entries in members.values():
        out.update(state_from_jax(entries, device))
    return out
