#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch/CUDA port, on the card it starts on.

    python3 cudabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It finds the cell in ``BENCHMARK.json``, makes the
cell's inputs on the card from the seed, builds the configuration's metrics, warms up
the cell's own shapes, drives the window for ``--seconds`` in the traffic's loop shape,
checks every answer against the plain reference, and prints one JSON line last on
standard output. With ``--trace 0`` that line holds the cell's end-to-end metrics; with
``--trace 1`` a profiled window gives its per-layer metrics, the device's busy time and
a breakdown. A traffic mix with ``ranks`` > 1 runs one process per card (this one is
rank 0 and starts the others), synced over NCCL. Without a CUDA card, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "cudabench" / ".cache"  # every compile cache of a run, at a fixed path in the checkout


def _environment() -> None:
    """Caches inside the checkout; nothing that would load JAX into the process."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host loop is single-threaded, and idle worker
    # threads of the CPU pools would only compete with it for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a traffic mix with several ranks: rank 0 (the run started) starts the others with these
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _start_ranks(args, world: int, port: int) -> list:
    """The ranks 1 .. world-1, each a process of this script on its own card."""
    base = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace), "--port", str(port)]
    return [subprocess.Popen(base + ["--rank", str(r)], stdout=subprocess.DEVNULL) for r in range(1, world)]


def _stop_ranks(workers: list) -> bool:
    """Wait for every other rank; end any still running. Whether all exited with 0."""
    ok = True
    for w in workers:
        try:
            ok &= w.wait(timeout=120) == 0
        except subprocess.TimeoutExpired:
            w.kill()
            w.wait()
            ok = False
    return ok


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    from cudabench.harness import spec

    cell = spec.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cudabench: {cell.name} needs {cell.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    from cudabench.harness import ranks as ranks_mod
    from cudabench.harness.cell import run_cell
    from cudabench.harness.checks import print_table
    from cudabench.harness.imports import forbidden_modules

    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    world = int(cell.traffic.get("ranks", 1))
    workers, ranks = [], None
    try:
        if world > 1:
            os.environ["NCCL_SHM_DISABLE"] = "1"  # nothing written to /dev/shm
            port = args.port or ranks_mod.free_port()
            if args.rank == 0:
                workers = _start_ranks(args, world, port)
            ranks = ranks_mod.init(args.rank, world, port, "nccl")
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, _T0, ranks=ranks)
    finally:
        ranks_mod.close()
        workers_ok = _stop_ranks(workers)
    if args.rank != 0:
        return 0
    if not workers_ok:
        print("cudabench: another rank failed", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"cudabench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = {
        "correct": out.correct,
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": out.metrics,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": cell.chips,
            "memory_peak_bytes": out.memory_peak_bytes,
            "power_limit": _power_limit(),
        },
    }
    if args.trace:
        if not out.busy_s:
            print("cudabench: the profiler saw no device activity in the traced window", file=sys.stderr)
            return 4
        result["device"].update(busy_s=out.busy_s, window_s=out.window_s)
        result["breakdown"] = out.breakdown
    result["checks"] = out.table
    print("cudabench: " + json.dumps(out.notes), file=sys.stderr)
    print_table(out.table)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
