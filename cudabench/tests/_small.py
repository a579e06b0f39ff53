"""Small sizes of each cell, for runs on the CPU."""

import dataclasses

from cudabench.harness import spec

SIZES = {
    "imagenet1k_suite": ({"rows": 600, "num_classes": 20, "per_class": 30}, 128),
    "deepseek_v3_vocab_eval": ({"vocab_size": 50, "seq_len": 16, "batches_cycled": 2}, 32),
}
# a traffic whose batch is narrower than its configuration's small one keeps a narrower batch
SMALL_ROWS = {"b256": 32}
CELLS = ["imagenet1k_suite.b4096", "imagenet1k_suite.b4096_steplog", "deepseek_v3_vocab_eval.b8192",
         "imagenet1k_suite.b256"]
DDP_CELL = "imagenet1k_suite.ddp4_b4096"


# the four-rank cell, kept out of BENCHMARK.json until its spread allows a bound (PERF.md)
DDP_ENTRY = {"name": DDP_CELL, "config": "imagenet1k_suite", "traffic": "ddp4_b4096", "chips": 4, "why": "-"}


def small_cell(name: str):
    """The cell with its traffic's batch cut to the small size, and the size overrides."""
    bench = spec.load_benchmark()
    if name == DDP_CELL and all(w["name"] != name for w in bench["workloads"]):
        bench["workloads"].append(DDP_ENTRY)
    cell = spec.resolve(name, bench)
    sizes, rows = SIZES[cell.config_name]
    rows = SMALL_ROWS.get(cell.traffic_name, rows)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, batch_rows=rows)), sizes


def ddp_rank(rank: int, world: int, port: int, name: str, fault: str, queue) -> None:
    """One rank of a small distributed run on the CPU over gloo; rank 0 puts
    ``(correct, failed, table)`` on ``queue``. ``fault="no_sync"`` leaves the exchange
    between ranks out: every member computes over its own shard alone."""
    import time

    import torch

    from cudabench.harness import ranks as ranks_mod
    from cudabench.harness.cell import run_cell

    cell, sizes = small_cell(name)

    def no_sync(metrics):
        for m in metrics.values():
            m.sync_on_compute = False
            m._to_sync = False
        return metrics

    r = ranks_mod.init(rank, world, port, "gloo")
    try:
        out = run_cell(cell, 2**31 + 17, 0.2, False, torch.device("cpu"), time.perf_counter(), sizes=sizes,
                       wrap=no_sync if fault == "no_sync" else None, ranks=r)
    finally:
        ranks_mod.close()
    if rank == 0:
        queue.put((out.correct, out.failed, {k: v["value"] for k, v in out.table.items()}))
