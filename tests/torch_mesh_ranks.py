"""Run one test body on N gloo ranks of the CPU, one process per rank.

``run_ranks(tmp_path, body, world)`` writes a script holding ``body`` (which defines
``run(rank) -> dict``), starts it in a fresh interpreter, which spawns ``world``
processes joined by a gloo group over ``tcp://localhost``, and returns each rank's
JSON-able result. A rank that raises reports ``{"ok": False, "error", "message",
"trace"}``; a rank that hangs past the join timeout fails the test. The ranks import
the port only (``device="cpu"``), never JAX: the caller holds their results against
the JAX package in its own process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240

_RUNNER = textwrap.dedent(
    """
    import datetime, json, os, socket, sys, time, traceback
    import multiprocessing as mp
    sys.path.insert(0, {root!r})

    {body}

    def _child(rank, port, out, world):
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{{port}}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds={timeout}),
        )
        try:
            res = {{"ok": True, **run(rank)}}
        except Exception as err:
            res = {{"ok": False, "error": type(err).__name__, "message": str(err),
                    "trace": traceback.format_exc()}}
        with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
            json.dump(res, f)
        sys.stdout.flush()
        os._exit(0)

    if __name__ == "__main__":
        out, world = sys.argv[1], int(sys.argv[2])
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child, args=(r, port, out, world)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + {timeout}
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        print(json.dumps({{"hung": hung}}))
        sys.exit(1 if hung else 0)
    """
)


def run_ranks(tmp_path, body: str, world: int) -> List[dict]:
    """Each rank's ``{"ok": True, **run(rank)}`` (asserting that every rank finished)."""
    script = tmp_path / "ranks.py"
    script.write_text(_RUNNER.format(root=ROOT, body=textwrap.dedent(body), timeout=JOIN_TIMEOUT_S))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.pop("TORCHMETRICS_TPU_SHARD", None)
    res = subprocess.run(
        [sys.executable, str(script), str(tmp_path), str(world)],
        capture_output=True, text=True, timeout=JOIN_TIMEOUT_S + 30, env=env,
    )
    assert res.returncode == 0, f"a rank hung or died:\n{res.stdout}\n{res.stderr[-4000:]}"
    out = []
    for rank in range(world):
        path = tmp_path / f"rank{rank}.json"
        assert path.exists(), f"rank {rank} wrote no result:\n{res.stdout}\n{res.stderr[-4000:]}"
        out.append(json.loads(path.read_text()))
    failed = [f"rank {r} raised {o.get('error')}: {o.get('message')}\n{o.get('trace')}" for r, o in enumerate(out) if not o["ok"]]
    assert not failed, "\n".join(failed)
    return out
