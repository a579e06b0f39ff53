"""On a card: each one-card cell's whole run at a small size comes out correct, and the
look for a card decides. Run there with ``python -m pytest cudabench/tests -m cuda``."""

import time

import pytest
import torch

from _small import CELLS, small_cell
from cudabench.harness.cell import run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell, sizes = small_cell(name)
    out = run_cell(cell, 2**31 + 23, 0.2, True, torch.device("cuda", 0), time.perf_counter(), sizes=sizes)
    assert out.correct and out.failed == 0, out.table
    assert out.busy_s and out.busy_s > 0
