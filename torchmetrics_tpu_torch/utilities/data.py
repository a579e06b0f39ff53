"""Core data and reduction primitives (counterpart of ``torchmetrics_tpu/utilities/data.py``)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch


def dim_zero_cat(x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    """Concatenate a (list of) tensor(s) along dim 0."""
    if isinstance(x, torch.Tensor):
        return x
    x = [y if y.ndim else y.reshape(1) for y in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat(x, dim=0)


def dim_zero_sum(x: torch.Tensor) -> torch.Tensor:
    """Summation along dim 0, keeping the dtype of the states."""
    return x.sum(dim=0, dtype=x.dtype)


def dim_zero_mean(x: torch.Tensor) -> torch.Tensor:
    """Average along dim 0."""
    return x.mean(dim=0)


def dim_zero_max(x: torch.Tensor) -> torch.Tensor:
    """Max along dim 0."""
    return x.max(dim=0).values


def dim_zero_min(x: torch.Tensor) -> torch.Tensor:
    """Min along dim 0."""
    return x.min(dim=0).values


def _flatten(x: Sequence) -> list:
    """Flatten a list of lists into one list."""
    return [item for sublist in x for item in sublist]


def _one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """One-hot of labels along a new last axis, as a comparison with the class indices; a
    label outside ``[0, num_classes)`` gives a row of zeros. It reads nothing back:
    ``torch.nn.functional.one_hot`` checks the labels' range on the host, a sync that
    keeps an update out of a captured graph."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(dtype)


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Integer labels ``(N, ...)`` to one-hot ``(N, C, ...)``: int64 for int64 labels,
    int32 otherwise. Only ``num_classes=None`` reads the host, for the labels' ``max()``,
    as the JAX package does."""
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    dtype = torch.int64 if label_tensor.dtype == torch.int64 else torch.int32
    return torch.movedim(_one_hot(label_tensor, num_classes, dtype), -1, 1)


_SAME_WIDTH_INT = {torch.float64: torch.int64, torch.float32: torch.int32, torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _total_order_keys(x: torch.Tensor) -> torch.Tensor:
    """Integer keys of the same width that order floats as IEEE's total order does:
    -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN. The float bits read as a signed
    integer, with the magnitude bits of negative values flipped. Integers are their own
    keys."""
    if not x.is_floating_point():
        return x
    int_dtype = _SAME_WIDTH_INT[x.dtype]
    bits = x.contiguous().view(int_dtype)
    magnitude = torch.iinfo(int_dtype).max
    return bits ^ ((bits >> (bits.element_size() * 8 - 1)) & magnitude)


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """Int32 mask of the top-k entries along ``dim``.

    ``topk == 1`` is the argmax: the first index wins a tie and NaN of either sign is
    maximal (K1's rule). ``topk > 1`` orders as ``jax.lax.top_k`` in the JAX package
    does: IEEE total order (+NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN), the
    lower index first among bit-equal values. It takes the first k of a stable
    ascending sort of the complemented total-order keys (``~key`` cannot overflow); a
    float sort ties -0.0 with +0.0 and ranks every NaN first, and ``Tensor.topk`` picks
    other indices among ties. The sort reads nothing back to the host, so it can be
    captured in a graph.
    """
    if topk == 1:
        idx = prob_tensor.argmax(dim=dim, keepdim=True)
    else:
        keys = ~_total_order_keys(prob_tensor)
        idx = torch.sort(keys, dim=dim, stable=True).indices.narrow(dim, 0, topk)
    mask = torch.zeros_like(prob_tensor, dtype=torch.int32)
    return mask.scatter_(dim, idx, 1)


def apply_to_collection(data: Any, dtype: Union[type, tuple], function: Callable, *args: Any, **kwargs: Any) -> Any:
    """Recursively apply ``function`` to every element of type ``dtype``."""
    if isinstance(data, dtype):
        return function(data, *args, **kwargs)
    if isinstance(data, dict):
        return type(data)({k: apply_to_collection(v, dtype, function, *args, **kwargs) for k, v in data.items()})
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return type(data)(*(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data))
    if isinstance(data, (list, tuple)):
        return type(data)(apply_to_collection(d, dtype, function, *args, **kwargs) for d in data)
    return data


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze size-1 tensors in a collection to 0-d tensors."""
    return apply_to_collection(data, torch.Tensor, lambda x: x.reshape(()) if x.numel() == 1 else x)


def _bincount(x: torch.Tensor, minlength: Optional[int] = None, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int32 bincount that drops negative and out-of-range indices, with no host sync.

    ``minlength`` also fixes the number of bins: indices at or past it are dropped,
    as the JAX package's ``mode="drop"`` scatter drops them. Every dropped index goes
    to one extra bin, which is sliced off, so the output shape never depends on the
    data. The counts are a scatter-add into ``minlength + 1`` int32 zeros:
    ``torch.bincount`` on CUDA reads the input's min and max back to the host to size
    its output, which is a device -> host sync on every call. Weights are cast to
    int32, as the JAX package casts them, and masked, not indexed.

    A caller that passes no ``minlength`` pays one ``max()`` sync to size the output,
    as the JAX package's eager use does.
    """
    if minlength is None:
        minlength = int(x.max()) + 1 if x.numel() else 1
    drop = (x < 0) | (x >= minlength)
    index = torch.where(drop, minlength, x).long().flatten()
    if weights is None:
        updates = torch.ones_like(index, dtype=torch.int32)
    else:
        updates = torch.where(drop, 0, weights.to(torch.int32)).flatten()
    counts = torch.zeros(minlength + 1, dtype=torch.int32, device=x.device)
    return counts.index_add_(0, index, updates)[:minlength]


def allclose(tensor1: torch.Tensor, tensor2: torch.Tensor, atol: float = 1e-8, rtol: float = 1e-5) -> bool:
    """Shape-aware ``torch.allclose`` (tensors of different shapes are not close)."""
    if tensor1.shape != tensor2.shape:
        return False
    return bool(torch.allclose(tensor1, tensor2, atol=atol, rtol=rtol))


def _cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Cumulative sum; deterministic on CUDA for integer inputs."""
    return torch.cumsum(x, dim=dim)


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """Int64 keys that sort as the JAX package sorts floats: ``-0.0`` ties with ``0.0``
    and every NaN ties with every other, after ``+inf``.

    ``torch.searchsorted`` bisects wrongly over a sorted tensor that holds NaN (a NaN
    compares neither below nor above), and a float sort's NaN placement depends on the
    NaN's sign bit on some backends; integer keys have neither problem. Every float
    dtype converts to float64 exactly, whose bit pattern, with the magnitude bits of
    negative values flipped, orders as an int64.
    """
    x = x.to(torch.float64)
    x = torch.where(x == 0, 0.0, x)
    bits = x.view(torch.int64)
    keys = bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)
    return torch.where(torch.isnan(x), torch.iinfo(torch.int64).max, keys)


def _argsort_descending(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable descending order of ``x`` along ``dim`` with NaN last: the JAX package's
    ``jnp.argsort(-x)`` (ties keep their input order)."""
    return torch.argsort(_order_keys(-x), dim=dim, stable=True)
