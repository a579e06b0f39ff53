#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell, in one process.

    python3 cudabench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2 [--control 1,2,3]

For each of ``--seeds`` it makes a whole run of the cell short of the printing (its own
inputs, metrics, warm-up, a window of ``--seconds``, the check) and prints its end-to-end
metrics and the numbers compared; for each of ``--control`` it prints the control's: the plain reference on
bfloat16-rounded logits in the program's place, against the reference at the
configuration's float32. One JSON object per line; the benchmark's own runs never run
this. Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from cudabench.harness import spec
    from cudabench.harness.cell import control, run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.resolve(args.workload)
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        out = run_cell(cell, seed, args.seconds, False, device, time.perf_counter())
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed, "correct": out.correct,
                          "calls": out.attempted, "metrics": {k: v["value"] for k, v in out.metrics.items()},
                          "gaps": {k: v["value"] for k, v in out.table.items()}}), flush=True)
        torch.cuda.empty_cache()
    for seed in [int(s) for s in args.control.split(",") if s]:
        gaps = control(cell, seed, device, calls=out.attempted if args.seeds else 0)
        print(json.dumps({"workload": cell.name, "side": "control", "seed": seed, "gaps": gaps}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
