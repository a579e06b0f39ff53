"""Cross-process state gathering over ``torch.distributed``, bounded.

Counterpart of ``gather_all_tensors`` in ``torchmetrics_tpu/parallel/sync.py``: gather
the shapes first; if all are equal do one plain ``all_gather``; otherwise pad every
local tensor to the elementwise largest shape, gather, and trim each result back to its
own shape. Both collectives ride ``parallel/resilience.bounded_collective`` under the
JAX labels ``eager:shape`` and ``eager:state``, so the eager path (every sync the packed
route cannot take) has the same deadline, retries, typed errors and fault hooks as the
packed backbone. With no policy and no planted fault the wrapper is a direct call.
``raw_all_gather`` is the one place either path enters ``torch.distributed``.

The JAX package's mesh-axis collectives (``axis_gather`` / ``axis_sum`` / ``axis_mean``
/ ``axis_max`` / ``axis_min``) run here over the process group of one named axis of a
rank mesh: an ``EvalMesh`` or the active state mesh (``parallel/sharding.py``), the
default group when neither names the axis. ``EvalMesh`` is a 1-D data-parallel mesh
over the ranks.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


__all__ = [
    "jit_distributed_available",
    "gather_all_tensors",
    "axis_gather",
    "axis_sum",
    "axis_mean",
    "axis_max",
    "axis_min",
    "EvalMesh",
]


def distributed_available() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    return dist.is_available() and dist.is_initialized()


def jit_distributed_available() -> bool:
    """Whether there is more than one process."""
    return world_size() > 1


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


# ------------------------------------------------------------------ mesh-axis collectives


def _axis_group(axis_name: str, mesh: Optional[Any], device_type: str) -> Optional[Any]:
    """The process group along ``axis_name`` of ``mesh``, else of the active state mesh,
    else None (the default group)."""
    if mesh is None:
        from torchmetrics_tpu_torch.parallel.sharding import metric_mesh

        mesh = metric_mesh()
    mesh = getattr(mesh, "mesh", mesh)
    if mesh is not None and axis_name in getattr(mesh, "shape", {}):
        return mesh.group(axis_name, device_type)
    return None


def _axis_reduce(x: torch.Tensor, axis_name: str, op: Any, mesh: Optional[Any]) -> torch.Tensor:
    if not distributed_available():
        return x
    out = x.clone()
    dist.all_reduce(out, op=op, group=_axis_group(axis_name, mesh, x.device.type))
    return out


def axis_gather(x: torch.Tensor, axis_name: str, mesh: Optional[Any] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name``, stacked on a new leading dim."""
    if not distributed_available():
        return x[None]
    return torch.stack(raw_all_gather(x.contiguous(), _axis_group(axis_name, mesh, x.device.type)))


def axis_sum(x: torch.Tensor, axis_name: str, mesh: Optional[Any] = None) -> torch.Tensor:
    """One all-reduce sum along ``axis_name``."""
    return _axis_reduce(x, axis_name, dist.ReduceOp.SUM, mesh)


def axis_mean(x: torch.Tensor, axis_name: str, mesh: Optional[Any] = None) -> torch.Tensor:
    """The mean along ``axis_name`` (an all-reduce sum over the axis size)."""
    group = _axis_group(axis_name, mesh, x.device.type) if distributed_available() else None
    return axis_sum(x, axis_name, mesh) / world_size(group)


def axis_max(x: torch.Tensor, axis_name: str, mesh: Optional[Any] = None) -> torch.Tensor:
    """One all-reduce max along ``axis_name``."""
    return _axis_reduce(x, axis_name, dist.ReduceOp.MAX, mesh)


def axis_min(x: torch.Tensor, axis_name: str, mesh: Optional[Any] = None) -> torch.Tensor:
    """One all-reduce min along ``axis_name``."""
    return _axis_reduce(x, axis_name, dist.ReduceOp.MIN, mesh)


class EvalMesh:
    """A 1-D data-parallel mesh over the first ``n_devices`` ranks (all by default),
    its axis named ``axis``: the mesh the axis collectives take."""

    def __init__(self, n_devices: Optional[int] = None, axis: str = "data") -> None:
        import numpy as np

        from torchmetrics_tpu_torch.parallel.sharding import StateMesh

        n = world_size() if n_devices is None else int(n_devices)
        self.axis = axis
        self.mesh = StateMesh((axis,), np.arange(n))

    @property
    def size(self) -> int:
        return self.mesh.size

    def shard_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of dim 0 of a global batch."""
        rank = dist.get_rank() if distributed_available() else 0
        rows = x.shape[0] // self.size
        return x[rank * rows : (rank + 1) * rows]

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself: every rank holds the whole value."""
        return x
