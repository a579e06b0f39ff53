"""The measured window: one loop shape, read from the traffic file, over whatever the
configuration's file builds.

A traffic file is a JSON object:

- ``batch_rows``: rows a batch holds (the configuration turns rows into its shapes), or
  a list of sizes that an epoch's batches take in turn;
- ``order`` (optional): ``seeded`` permutes that list by the run's seed, so every seed
  runs the same sizes in another order;
- ``config`` (optional): run-time keys of the configuration that this traffic
  overrides, each replaced whole (``dtype``, ``validate_args``, ``limits``);
- ``call``: ``update`` (dispatch ahead, no read) or ``forward`` (the batch's value);
- ``read_each_step``: read the batch value to the host after every call;
- ``epochs``: ``true`` walks the configuration's eval set in order, epoch after epoch,
  each ending in ``compute``, its values read to the host and ``reset``; ``false`` cycles
  the configuration's batches with no read at all, and the states are read once the
  window has closed;
- ``ranks`` (default 1): processes, one card each, every one walking its shard of each
  epoch; ``compute`` syncs them, and they agree when the window ends (``StopVote``).

The window starts at the first call and ends at a device sync after the last whole
epoch (or the last call). Each epoch is timed from its first call to its ``compute``
values on the host.
"""

from __future__ import annotations

import random
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from cudabench.harness.trace import Recorder

KEEP_EVERY = 64  # besides the first two and the last, one epoch's full values in this many are kept


@dataclass
class Batch:
    """One batch as the configuration hands it to the program."""

    args: tuple  # what update / forward take
    rows: int  # rows it folds into the states (scored tokens, images)
    index: int  # its place in the epoch (or in the cycle)
    nbytes: int  # its input bytes


@dataclass
class WindowResult:
    window_s: float = 0.0
    rows: int = 0
    calls: int = 0
    epoch_s: List[float] = field(default_factory=list)
    epochs: List[Tuple[int, Dict[str, Any]]] = field(default_factory=list)  # (epoch, values)
    steps: List[Tuple[int, int, Dict[str, Any]]] = field(default_factory=list)  # (epoch, batch, values)
    folds: Dict[int, int] = field(default_factory=dict)  # batch index -> times folded (streams)
    syncs_in_calls: int = 0
    syncs_counted: bool = False


class SyncCounter:
    """Device-to-host syncs inside the program's calls, as ``set_sync_debug_mode("warn")``
    reports them: a floor, since the mode sees only the syncs PyTorch itself flags."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.count = 0

    @contextmanager
    def around(self):
        if not self.enabled:
            yield
            return
        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.count += sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def batch_sizes(traffic: dict, seed: int) -> List[int]:
    """The traffic's batch sizes in the order the configuration's ``plan`` takes them."""
    rows = traffic["batch_rows"]
    sizes = [int(rows)] if isinstance(rows, int) else [int(r) for r in rows]
    if traffic.get("order") == "seeded":
        random.Random(seed).shuffle(sizes)
    return sizes


class StopVote:
    """Whether the window ends after this epoch, the same answer on every rank.

    One process ends after the first epoch that finds its time up. Ranks have to run the
    same number of syncing ``compute`` calls, so each posts its "time is up" after an
    epoch and reads the answer to the post it made one epoch before, which the ranks
    exchanged in the background while that epoch ran: no rank waits on the others for
    it, and the window runs one epoch past the first rank to find its time up."""

    def __init__(self, ranks=None) -> None:
        self.ranks = ranks
        self.pending: Optional[Callable[[], bool]] = None

    def __call__(self, time_up: bool) -> bool:
        if self.ranks is None:
            return time_up
        if self.pending is not None and self.pending():
            return True
        self.pending = self.ranks.post_any(time_up)
        return False


def _scalars(values: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in values.items() if getattr(v, "size", 1) == 1}


def _sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def run(cm, metrics, data, plan: List[Any], traffic: dict, seconds: float, rec: Recorder,
        seed: int, device, count_syncs: bool = False, ranks=None) -> WindowResult:
    """Drive ``metrics`` for ``seconds`` in the traffic's loop shape. ``plan`` is the
    configuration's list of batch slices; ``cm.batch(data, plan[i])`` makes batch ``i``.
    ``ranks``: this rank's place among several, which vote on the window's end."""
    if traffic["epochs"]:
        return _epochs(cm, metrics, data, plan, traffic, seconds, rec, seed, device, count_syncs, StopVote(ranks))
    return _stream(cm, metrics, data, plan, traffic, seconds, rec, device, count_syncs)


def _call(cm, metrics, batch: Batch, traffic: dict, rec: Recorder, syncs: SyncCounter):
    kind = traffic["call"]
    with syncs.around(), rec.span(kind, batch=batch.index):
        if kind == "forward":
            return cm.forward(metrics, batch)
        cm.update(metrics, batch)
        return None


def _epochs(cm, metrics, data, plan, traffic, seconds, rec, seed, device, count_syncs, stop) -> WindowResult:
    res = WindowResult()
    syncs = SyncCounter(count_syncs)
    keep = random.Random(seed)
    step_read = traffic["read_each_step"]
    epoch_rows = 0
    last = None
    t_start = time.perf_counter()
    while True:
        e0 = time.perf_counter()
        for item in plan:
            with rec.span("slice"):
                batch = cm.batch(data, item)
            out = _call(cm, metrics, batch, traffic, rec, syncs)
            if step_read:
                with rec.span("step_read"):
                    values = cm.read_step(out)
                res.steps.append((len(res.epoch_s), batch.index, values))
            res.calls += 1
            if not res.epoch_s:
                epoch_rows += batch.rows
        with rec.span("compute"):
            out = cm.compute(metrics)
        with rec.span("epoch_read"):
            values = cm.read_epoch(out)
        res.epoch_s.append(time.perf_counter() - e0)
        n = len(res.epoch_s) - 1
        kept = n < 2 or keep.random() < 1.0 / KEEP_EVERY
        res.epochs.append((n, values if kept else _scalars(values)))
        last = (n, values)
        with rec.span("reset"):
            cm.reset(metrics)
        res.rows += epoch_rows
        if stop(time.perf_counter() - t_start >= seconds):
            break
    with rec.span("drain"):
        _sync(device)
    res.window_s = time.perf_counter() - t_start
    res.epochs[-1] = last
    res.syncs_in_calls, res.syncs_counted = syncs.count, syncs.enabled
    return res


def _stream(cm, metrics, data, plan, traffic, seconds, rec, device, count_syncs) -> WindowResult:
    res = WindowResult()
    syncs = SyncCounter(count_syncs)
    i = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        with rec.span("slice"):
            batch = cm.batch(data, plan[i % len(plan)])
        _call(cm, metrics, batch, traffic, rec, syncs)
        res.folds[batch.index] = res.folds.get(batch.index, 0) + 1
        res.rows += batch.rows
        res.calls += 1
        i += 1
    with rec.span("drain"):
        _sync(device)
    res.window_s = time.perf_counter() - t_start
    res.syncs_in_calls, res.syncs_counted = syncs.count, syncs.enabled
    return res


def warm_up(cm, metrics, data, plan, traffic, device) -> None:
    """Run every shape the window will use, twice over (a second pass finds any build
    that only a second call makes), then reset the states."""
    rec = Recorder(False)
    syncs = SyncCounter(False)
    for _ in range(2):
        for item in plan:
            out = _call(cm, metrics, cm.batch(data, item), traffic, rec, syncs)
            if traffic["read_each_step"]:
                cm.read_step(out)
        cm.read_epoch(cm.compute(metrics))
        cm.reset(metrics)
    _sync(device)
