"""The check fails a broken program and the control: a whole run on the CPU at a small
size (the look for a card skipped) with the timed path broken underneath, once for each
fault a cell can have, and the control (the reference on bfloat16 logits in the
program's place) against the limits."""

import dataclasses
import time

import pytest
import torch

from _small import CELLS, small_cell
from cudabench.harness import checks, spec
from cudabench.harness.cell import control, run_cell

CPU = torch.device("cpu")


def _halve(args):
    n = args[0].shape[0]
    return tuple(a[: max(1, n // 2)] for a in args)


class Broken:
    """The metrics with one fault planted: ``unchanged`` (a step leaves the states as
    they were), ``half`` (half of each batch left out, the values taken over the rest),
    ``altered`` (an answer changed where it is produced)."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def update(self, *args):
        if self.fault == "unchanged":
            return
        self.inner.update(*(_halve(args) if self.fault == "half" else args))

    def __call__(self, *args):
        if self.fault == "unchanged":
            return self.inner.compute()
        return self._alter(self.inner(*(_halve(args) if self.fault == "half" else args)))

    def compute(self):
        return self._alter(self.inner.compute())

    def reset(self):
        self.inner.reset()

    def _alter(self, out):
        if self.fault != "altered":
            return out
        if isinstance(out, dict):
            key = sorted(k for k, v in out.items() if v.ndim == 0)[0]
            return dict(out, **{key: out[key] + 0.01})
        return out + 0.01

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _wrap(fault):
    def wrap(metrics):
        if isinstance(metrics, dict):
            return {k: Broken(m, fault) for k, m in metrics.items()}
        return Broken(metrics, fault)

    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    cell, sizes = small_cell(name)
    out = run_cell(cell, 2**31 + 3, 0.05, False, CPU, time.perf_counter(), sizes=sizes)
    assert out.correct and out.failed == 0, out.table
    assert set(out.metrics) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out.metrics.values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    """Caught: ``correct`` comes out false, or the program itself raises (the calibration
    error's ``compute`` over no rows does), and a run that raises prints no result."""
    cell, sizes = small_cell(name)
    try:
        out = run_cell(cell, 2**31 + 3, 0.05, False, CPU, time.perf_counter(), sizes=sizes, wrap=_wrap(fault))
    except ValueError as exc:
        assert fault == "unchanged" and "concatenate" in str(exc)
        return
    assert not out.correct, (fault, out.table)
    assert out.failed > 0


# sizes at which bfloat16 rounding shows, yet small enough for the CPU
CONTROL_SIZES = {
    "imagenet1k_suite": ({"rows": 4000, "num_classes": 1000, "per_class": 4}, 1024),
    "deepseek_v3_vocab_eval": ({"vocab_size": 32768, "seq_len": 256, "batches_cycled": 1}, 512),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, seed):
    cell, _ = small_cell(name)
    sizes, rows = CONTROL_SIZES[cell.config_name]
    rows = min(rows, spec.load_traffic(cell.traffic_name)["batch_rows"])  # the cell's own batch where narrower
    gaps = control(dataclasses.replace(cell, traffic=dict(cell.traffic, batch_rows=rows)), seed, CPU, sizes=sizes)
    correct, table = checks.decide(gaps, cell.config["limits"])
    assert not correct, table
