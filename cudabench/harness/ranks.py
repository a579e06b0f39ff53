"""Several ranks, one process and one card each, for a traffic mix with ``ranks`` > 1.

The program syncs over the default process group (NCCL on the cards, gloo in the CPU
tests); the benchmark keeps a gloo group of its own on the host for what only it needs:
agreeing when the window ends (every rank has to enter the same number of syncing
``compute`` calls) and gathering each rank's device readings to rank 0.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List

import torch
import torch.distributed as dist

TIMEOUT_S = 300  # a collective that waits longer than this fails the run


@dataclass
class Ranks:
    rank: int
    world: int
    ctl: Any  # the benchmark's own gloo group

    def post_any(self, flag: bool) -> Callable[[], bool]:
        """Start exchanging ``flag`` in the background; the call returned waits for the
        exchange and says whether any rank said ``flag``, the same answer on every rank."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        work = dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.ctl, async_op=True)

        def answer() -> bool:
            work.wait()
            return bool(t.item())

        return answer

    def gather(self, obj: Any) -> List[Any]:
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.ctl)
        return out


def free_port() -> int:
    """A free TCP port on this host's loopback, for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, backend: str) -> Ranks:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    ctl = dist.new_group(backend="gloo", timeout=timedelta(seconds=TIMEOUT_S)) if backend != "gloo" else dist.group.WORLD
    return Ranks(rank, world, ctl)


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
