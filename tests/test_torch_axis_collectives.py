"""The port's mesh-axis collectives (``parallel/sync.py``: ``axis_sum`` / ``axis_mean`` /
``axis_max`` / ``axis_min`` / ``axis_gather``) on 4 gloo ranks of the CPU.

Each rank holds seeded integer-valued float32 rows, so every fold is exact in any order.
The ranks run each collective over ``EvalMesh()`` (one axis over the 4 ranks) and over
each axis of a ``(data 2, state 2)`` mesh, given and active, and the parent holds each
result against the host fold of the ranks' inputs along that axis. An axis name that is
not on the mesh raises ``TorchMetricsUserError`` naming the mesh's axes, as the JAX
collectives raise on an unbound axis name; with no mesh at all the collectives run over
the whole world. (The JAX package's own ``axis_*`` tests call ``shard_map(check_rep=)``,
which jax 0.9 no longer takes, so the reference here is the host fold.)
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.torch_mesh_ranks import run_ranks

WORLD = 4
WIDTH = 3
OPS = ("sum", "mean", "max", "min", "gather")


def _rows(rank: int) -> np.ndarray:
    return np.random.RandomState(100 + rank).randint(-50, 50, WIDTH).astype(np.float32)


_BODY = '''
def run(rank):
    import numpy as np
    import torch
    from torchmetrics_tpu_torch.parallel import sharding
    from torchmetrics_tpu_torch.parallel.sync import EvalMesh, axis_gather, axis_max, axis_mean, axis_min, axis_sum
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

    x = torch.from_numpy(np.random.RandomState(100 + rank).randint(-50, 50, WIDTH).astype(np.float32))
    fns = {"sum": axis_sum, "mean": axis_mean, "max": axis_max, "min": axis_min, "gather": axis_gather}
    out = {}

    def each(tag, axis, mesh):
        for op, fn in fns.items():
            out[f"{tag}:{op}"] = fn(x, axis, mesh).tolist()

    def raises(tag, call):
        try:
            call()
        except TorchMetricsUserError as err:
            out[tag] = str(err)
        else:
            out[tag] = None

    each("eval", "data", EvalMesh())
    grid = sharding.StateMesh(("data", "state"), np.arange(WORLD).reshape(2, 2))
    for axis in ("data", "state"):
        each(f"2x2:{axis}", axis, grid)
    with sharding.mesh_context(data=2, state=2):
        for axis in ("data", "state"):
            each(f"active:{axis}", axis, None)
        raises("active:bogus", lambda: axis_sum(x, "bogus"))
    each("world", "anything", None)
    for op, fn in fns.items():
        raises(f"bogus:{op}", lambda fn=fn: fn(x, "bogus", grid))
    raises("eval:bogus", lambda: axis_sum(x, "state", EvalMesh()))
    return out
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    consts = f"WORLD = {WORLD}\nWIDTH = {WIDTH}\n"
    return run_ranks(tmp_path_factory.mktemp("axis"), consts + _BODY, WORLD)


def _fold(op: str, members: list) -> list:
    rows = np.stack([_rows(r) for r in members])
    if op == "gather":
        return rows.tolist()
    return {"sum": rows.sum(0), "mean": rows.sum(0) / len(members), "max": rows.max(0), "min": rows.min(0)}[op].tolist()


def _members(axis: str, rank: int) -> list:
    """The ranks along ``axis`` through ``rank`` on the 2x2 mesh (rank r sits at (r // 2, r % 2))."""
    row, col = divmod(rank, 2)
    return [col, 2 + col] if axis == "data" else [2 * row, 2 * row + 1]


@pytest.mark.parametrize("op", OPS)
def test_eval_mesh_folds_the_whole_world(ranks, op):
    for r in ranks:
        assert r[f"eval:{op}"] == _fold(op, list(range(WORLD)))


@pytest.mark.parametrize("tag", ["2x2", "active"])
@pytest.mark.parametrize("axis", ["data", "state"])
@pytest.mark.parametrize("op", OPS)
def test_each_axis_of_a_2x2_mesh_folds_its_ranks(ranks, tag, axis, op):
    for rank, r in enumerate(ranks):
        assert r[f"{tag}:{axis}:{op}"] == _fold(op, _members(axis, rank)), (rank, tag, axis, op)


@pytest.mark.parametrize("op", OPS)
def test_no_mesh_runs_over_the_world(ranks, op):
    for r in ranks:
        assert r[f"world:{op}"] == _fold(op, list(range(WORLD)))


@pytest.mark.parametrize("op", OPS)
def test_an_unknown_axis_raises_naming_the_mesh_axes(ranks, op):
    for r in ranks:
        message = r[f"bogus:{op}"]
        assert message is not None, f"axis_{op} over an unknown axis ran"
        assert "'bogus'" in message and "'data'" in message and "'state'" in message


def test_an_unknown_axis_of_the_active_or_eval_mesh_raises(ranks):
    for r in ranks:
        assert r["active:bogus"] is not None and "'state'" in r["active:bogus"]
        assert r["eval:bogus"] is not None and "('data',)" in r["eval:bogus"]


def test_an_unknown_axis_raises_without_a_process_group():
    from torchmetrics_tpu_torch.parallel.sync import EvalMesh, axis_sum
    from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
    import torch

    x = torch.ones(2)
    assert torch.equal(axis_sum(x, "data", EvalMesh(1)), x)
    with pytest.raises(TorchMetricsUserError, match="'bogus'"):
        axis_sum(x, "bogus", EvalMesh(1))
