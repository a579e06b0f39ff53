"""The decision on ``correct``: every number compared against its limit.

The configuration's reference module turns the program's answers and its own into
named numbers (gaps); the configuration's JSON gives each name its limit under
``limits``. A run is correct when every number is within its limit, and a number with no
limit is a fault of the benchmark, never a pass.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Tuple


def decide(gaps: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value": gap, "limit": limit}}) in the order of ``gaps``."""
    table = {}
    correct = bool(gaps)
    for name, gap in gaps.items():
        if name not in limits:
            raise KeyError(f"the compared number {name!r} has no limit in the configuration")
        limit = float(limits[name])
        gap = float(gap)
        table[name] = {"value": gap, "limit": limit}
        if math.isnan(gap) or gap > limit:
            correct = False
    return correct, table


def print_table(table: Dict[str, dict], stream=None) -> None:
    """Each number compared beside its limit, one per line: the last lines on stderr."""
    stream = stream if stream is not None else sys.stderr
    for name, row in table.items():
        verdict = "ok" if row["value"] <= row["limit"] else "OVER"
        print(f"check {name} {row['value']!r} limit {row['limit']!r} {verdict}", file=stream)
    stream.flush()


def worst(pairs: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest value of each name over several answers (NaN wins)."""
    out: Dict[str, float] = {}
    for gaps in pairs:
        for name, gap in gaps.items():
            prev = out.get(name)
            if prev is None or (not math.isnan(prev) and (math.isnan(gap) or gap > prev)):
                out[name] = gap
    return out
