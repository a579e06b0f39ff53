"""Order statistics used by the benchmark's metrics."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile by ``statistics.quantiles(..., n=100, method="inclusive")``."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def median(values: Sequence[float]) -> float:
    return float(statistics.median(values))
