"""Snapshots of a metric whose loop updates on a side stream, on the card.

The port's engine replays, and an eager update runs, on the updating thread's
current stream, and a replay writes the state buffers in place. A snapshot's copy is
enqueued on the stream that last wrote the state, so it lands after every write up
to its watermark and before the next. Here the loop runs on a side stream, each
update behind a matrix product that keeps the stream busy, so a copy ordered on any
other stream would read a state some updates old.

Imports neither JAX nor the JAX package: it runs where only the port is installed.
Run it on the card with ``python3 -m pytest -m cuda tests/test_torch_serve_cuda.py``.
"""

from __future__ import annotations

import threading

import pytest
import torch

#: updates of the loop, each behind a (LAG_N, LAG_N) float32 product on its stream
LOOP_UPDATES, LAG_N = 200, 2048
#: every update adds INPUT_N ones: a consistent copy holds watermark * INPUT_N
INPUT_N = 1 << 22
SNAPSHOTS = 16


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", [True, False], ids=["engine", "eager"])
def test_snapshot_follows_a_side_stream(engine):
    from torchmetrics_tpu_torch.aggregation import SumMetric
    from torchmetrics_tpu_torch.engine import engine_context
    from torchmetrics_tpu_torch.serve import WindowedMetric, snapshot_compute, take_snapshot

    device = _card()
    m = WindowedMetric(SumMetric(nan_strategy=0.0, compiled_update=engine), buckets=4, bucket_size=1 << 20)
    ones = torch.ones(INPUT_N, device=device)
    lag = torch.randn(LAG_N, LAG_N, device=device)
    side = torch.cuda.Stream(device)
    results, errors = [], []

    def scraper() -> None:
        try:
            while len(results) < SNAPSHOTS:
                snap = take_snapshot(m)
                results.append((snap.update_count, float(snapshot_compute(m, snap))))
        except BaseException as err:  # noqa: BLE001 -- reported to the loop thread
            errors.append(err)

    with engine_context(engine):
        m.update(ones)
        torch.cuda.synchronize()
        thread = threading.Thread(target=scraper, daemon=True)
        thread.start()
        with torch.cuda.stream(side):
            for _ in range(LOOP_UPDATES):
                lag = lag @ lag / LAG_N  # keeps the side stream some updates behind the host
                m.update(ones)
        thread.join(120)
        torch.cuda.synchronize()
    assert not thread.is_alive() and not errors, errors
    assert len(results) == SNAPSHOTS
    for watermark, value in results:
        assert value == watermark * INPUT_N, (watermark, value)
    assert float(m.compute()) == (LOOP_UPDATES + 1) * INPUT_N
