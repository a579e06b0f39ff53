"""Cross-process state gathering over ``torch.distributed``.

Counterpart of ``gather_all_tensors`` in ``torchmetrics_tpu/parallel/sync.py``: gather
the shapes first; if all are equal do one plain ``all_gather``; otherwise pad every
local tensor to the elementwise largest shape, gather, and trim each result back to its
own shape. The JAX package's in-graph mesh-axis collectives have no counterpart here.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def distributed_available() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def _simple_gather_all_tensors(result: torch.Tensor, group: Any, world_size: int) -> List[torch.Tensor]:
    gathered = [torch.zeros_like(result) for _ in range(world_size)]
    dist.all_gather(gathered, result, group=group)
    return gathered


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
    world_size = dist.get_world_size(group)
    if result.ndim == 0:
        return _simple_gather_all_tensors(result, group, world_size)

    local_size = torch.tensor(result.shape, device=result.device)
    local_sizes = _simple_gather_all_tensors(local_size, group, world_size)
    sizes = [tuple(int(d) for d in s.tolist()) for s in local_sizes]
    if all(s == sizes[0] for s in sizes):
        return _simple_gather_all_tensors(result, group, world_size)

    max_size = [max(s[d] for s in sizes) for d in range(result.ndim)]
    pad = []
    for m, s in zip(reversed(max_size), reversed(result.shape)):
        pad.extend([0, m - s])
    gathered = _simple_gather_all_tensors(F.pad(result, pad), group, world_size)
    return [g[tuple(slice(0, d) for d in s)] for g, s in zip(gathered, sizes)]
