"""Cross-process state gathering over ``torch.distributed``, bounded.

Counterpart of ``gather_all_tensors`` in ``torchmetrics_tpu/parallel/sync.py``: gather
the shapes first; if all are equal do one plain ``all_gather``; otherwise pad every
local tensor to the elementwise largest shape, gather, and trim each result back to its
own shape. Both collectives ride ``parallel/resilience.bounded_collective`` under the
JAX labels ``eager:shape`` and ``eager:state``, so the eager path (every sync the packed
route cannot take) has the same deadline, retries, typed errors and fault hooks as the
packed backbone. With no policy and no planted fault the wrapper is a direct call.
``raw_all_gather`` is the one place either path enters ``torch.distributed``. The JAX
package's in-graph mesh-axis collectives have no counterpart here.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def distributed_available() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size(group: Optional[Any] = None) -> int:
    """The number of processes in ``group`` (the default group), 1 without one."""
    return dist.get_world_size(group) if distributed_available() else 1


def raw_all_gather(x: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """One ``torch.distributed.all_gather`` of ``x`` on its own device: a list of every
    rank's tensor. Every rank passes a tensor of the same shape and dtype."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def _bounded_allgather(x: torch.Tensor, label: str, group: Optional[Any]) -> List[torch.Tensor]:
    """One eager-path gather under the resilience policy (``raw_all_gather`` is looked
    up at call time, so a retry sees the live function)."""
    from torchmetrics_tpu_torch.parallel.resilience import bounded_collective

    return bounded_collective(lambda t: raw_all_gather(t, group), label=label, payload=x)


def _simple_gather_all_tensors(result: torch.Tensor, group: Any) -> List[torch.Tensor]:
    """The equal-shape gather (one row per rank of ``group``), bounded under ``eager:state``."""
    return list(_bounded_allgather(result, "eager:state", group))


def gather_all_tensors(result: torch.Tensor, group: Optional[Any] = None) -> List[torch.Tensor]:
    """Gather one (possibly ragged) tensor from every process of ``group``.

    Every rank must hold a tensor of the same number of dimensions. Without a
    process group this returns ``[result]``.
    """
    if not distributed_available():
        return [result]
    if group is None:
        group = dist.group.WORLD
    result = result.contiguous()
    if result.ndim == 0:
        return _simple_gather_all_tensors(result, group)

    local_size = torch.tensor(result.shape, device=result.device)
    sizes = [tuple(int(d) for d in s.tolist()) for s in _bounded_allgather(local_size, "eager:shape", group)]
    if all(s == sizes[0] for s in sizes):
        return _simple_gather_all_tensors(result, group)

    max_size = [max(s[d] for s in sizes) for d in range(result.ndim)]
    pad = []
    for m, s in zip(reversed(max_size), reversed(result.shape)):
        pad.extend([0, m - s])
    gathered = _bounded_allgather(F.pad(result, pad), "eager:state", group)
    return [g[tuple(slice(0, d) for d in s)] for g, s in zip(gathered, sizes)]
