"""The port's two sync-path repairs: a sync-free ``_bincount`` and the list-state guard.

- ``utilities.data._bincount`` counts into ``minlength + 1`` bins (every dropped index
  in the last, which is cut off), so its output shape never depends on the data; it
  must give what the boolean-mask version gave and what the JAX package's gives.
- Ragged list states across ranks must raise ``TorchMetricsUserError`` on every rank,
  on the packed route and on the eager one, instead of leaving one rank waiting in a
  collective the other never enters. Two CPU processes over gloo; each run has a join
  timeout, so a deadlock fails the test instead of hanging it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.utilities import data as jdata
from torchmetrics_tpu_torch.utilities import data as tdata

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 45

_RUNNER = textwrap.dedent(
    """
    import datetime, json, os, socket, sys, time
    import multiprocessing as mp
    sys.path.insert(0, {root!r})

    {body}

    def _child(rank, port, out):
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{{port}}", world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=120),
        )
        try:
            res = {{"ok": True, **run(rank)}}
        except Exception as err:  # reported to the test, which decides
            res = {{"ok": False, "error": type(err).__name__, "message": str(err)}}
        with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
            json.dump(res, f)
        # stay in the group until every rank has reported: a rank that left early
        # would turn a peer's wait in a collective into a connection error
        give_up = time.monotonic() + {timeout} + 10
        while time.monotonic() < give_up and not all(
            os.path.exists(os.path.join(out, f"rank{{r}}.json")) for r in range(2)
        ):
            time.sleep(0.05)
        dist.destroy_process_group()

    if __name__ == "__main__":
        out = sys.argv[1]
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child, args=(r, port, out)) for r in range(2)]
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
        print(json.dumps({{"hung": hung, "exitcodes": [p.exitcode for p in procs]}}))
        sys.exit(1 if hung else 0)
    """
)


def run_two_ranks(tmp_path, body: str) -> list:
    """Run ``body`` (which defines ``run(rank) -> dict``) on two gloo ranks; return each
    rank's result. Fails if a rank is still running after the join timeout."""
    script = tmp_path / "two_ranks.py"
    script.write_text(_RUNNER.format(root=ROOT, body=textwrap.dedent(body), timeout=JOIN_TIMEOUT_S))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    res = subprocess.run(
        [sys.executable, str(script), str(tmp_path)],
        capture_output=True, text=True, timeout=JOIN_TIMEOUT_S + 30, env=env,
    )
    assert res.returncode == 0, f"a rank hung or died:\n{res.stdout}\n{res.stderr}"
    results = []
    for rank in range(2):
        path = tmp_path / f"rank{rank}.json"
        assert path.exists(), f"rank {rank} wrote no result:\n{res.stdout}\n{res.stderr}"
        results.append(json.loads(path.read_text()))
    return results


# ---------------------------------------------------------------- _bincount


def _bincount_masked(x, minlength=None, weights=None):
    """The boolean-mask version the repair replaced (``x[keep]`` is a host sync on CUDA)."""
    if minlength is None:
        minlength = int(x.max()) + 1 if x.numel() else 1
    keep = (x >= 0) & (x < minlength)
    w = None if weights is None else weights[keep].to(torch.int32).to(torch.float64)
    return torch.bincount(x[keep].long(), weights=w, minlength=minlength).to(torch.int32)


@pytest.mark.parametrize("minlength", [None, 1, 6, 11])
@pytest.mark.parametrize("weighted", [False, True])
def test_bincount_matches_masked_version_and_jax(minlength, weighted):
    rng = np.random.default_rng(minlength or 0)
    x = rng.integers(-4, 14, 300)
    x[:3] = [-1, 0, 13]  # negative, in range, past the end
    weights = rng.integers(0, 5, 300).astype(np.float32) if weighted else None
    tw = None if weights is None else torch.from_numpy(weights)
    jw = None if weights is None else jnp.asarray(weights)
    got = tdata._bincount(torch.from_numpy(x), minlength=minlength, weights=tw)
    assert got.dtype == torch.int32
    if minlength is not None:
        assert got.shape == (minlength,)
    np.testing.assert_array_equal(got.numpy(), _bincount_masked(torch.from_numpy(x), minlength, tw).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdata._bincount(jnp.asarray(x), minlength, jw)))


def test_bincount_empty_and_all_dropped():
    empty = torch.zeros(0, dtype=torch.long)
    assert tdata._bincount(empty, minlength=4).tolist() == [0, 0, 0, 0]
    assert tdata._bincount(empty).tolist() == [0]
    assert tdata._bincount(torch.tensor([-1, -7, 9]), minlength=3).tolist() == [0, 0, 0]


# ---------------------------------------------------------------- list-state guard

_EMPTY_VS_NONEMPTY_CAT = """
import torch
from torchmetrics_tpu_torch import MulticlassAUROC
from torchmetrics_tpu_torch.parallel import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

def _raises(call):
    try:
        call()
    except TorchMetricsUserError as err:
        return str(err)
    return None

def run(rank):
    m = MulticlassAUROC(num_classes=3, device="cpu")  # exact mode: cat list states
    if rank == 0:
        gen = torch.Generator().manual_seed(0)
        m.update(torch.rand(8, 3, generator=gen), torch.randint(0, 3, (8,), generator=gen))
    packed = _raises(m.sync)
    eager = _raises(lambda: m.sync(dist_sync_fn=gather_all_tensors))
    return {"packed": packed, "eager": eager, "synced": m._is_synced}
"""

_NONE_LIST_SHAPES = """
import torch
from torchmetrics_tpu_torch import Metric
from torchmetrics_tpu_torch.parallel import gather_all_tensors
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

class Packs(Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("packs", default=[], dist_reduce_fx=None)

    def update(self, x):
        self.packs.append(x)

    def compute(self):
        return self.packs

def _raises(call):
    try:
        call()
    except TorchMetricsUserError as err:
        return str(err)
    return None

def run(rank):
    m = Packs(device="cpu")
    m.update(torch.ones(2 + rank, 3))  # equal counts, unequal shapes
    packed = _raises(m.sync)
    eager = _raises(lambda: m.sync(dist_sync_fn=gather_all_tensors))
    return {"packed": packed, "eager": eager, "synced": m._is_synced}
"""


def test_empty_vs_nonempty_cat_state_raises_on_every_rank(tmp_path):
    """Rank 0 holds one exact-AUROC batch, rank 1 none: both routes raise on both ranks."""
    results = run_two_ranks(tmp_path, _EMPTY_VS_NONEMPTY_CAT)
    for rank, res in enumerate(results):
        assert res["ok"], res
        for route in ("packed", "eager"):
            assert res[route] is not None, f"rank {rank}: the {route} sync did not raise"
            # the eager guard counts list elements, the packed plan rows: rank 1 has none
            assert re.search(r"differing element counts \[[1-9]\d*, 0\]", res[route]), res[route]
        assert res["synced"] is False


def test_none_list_with_unequal_shapes_raises_on_every_rank(tmp_path):
    """Equal element counts, unequal element shapes: the shape-fingerprint error, both routes."""
    results = run_two_ranks(tmp_path, _NONE_LIST_SHAPES)
    for rank, res in enumerate(results):
        assert res["ok"], res
        for route in ("packed", "eager"):
            assert res[route] is not None, f"rank {rank}: the {route} sync did not raise"
            assert "mismatched per-element shapes" in res[route], res[route]
        assert res["synced"] is False
