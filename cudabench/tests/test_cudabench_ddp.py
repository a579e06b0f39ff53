"""The four-rank cell's path on the CPU: four processes over gloo, each on its shard,
the epoch's values synced by the program and checked on rank 0 against the whole eval
set; and the same with the exchange between ranks left out, which has to fail."""

import multiprocessing as mp

from _small import DDP_CELL, ddp_rank
from cudabench.harness import ranks as ranks_mod

WORLD = 4


def _run(fault: str):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = ranks_mod.free_port()
    procs = [ctx.Process(target=ddp_rank, args=(r, WORLD, port, DDP_CELL, fault, queue)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        result = queue.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in procs)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return result


def test_four_ranks_synced_are_correct():
    correct, failed, table = _run("none")
    assert correct and failed == 0, table


def test_exchange_left_out_is_caught():
    correct, failed, table = _run("no_sync")
    assert not correct and failed > 0, table
