"""Device: of the card's idle time over the traced window (the trace's gaps), the share
that fell while the host was inside one of the program's root spans, once aligned: idle
time the program's own host work left, against the benchmark loop's."""

from cudabench.harness.trace import merge
from cudabench.layer_metrics import _program_spans


def read(tr):
    a = _program_spans.aligned(tr)
    if a is None:
        return None
    idle = sum(b - a0 for a0, b in tr.trace.gaps)
    if idle <= 0:
        return None
    inside = merge(a.intervals)
    covered, j = 0.0, 0
    for g0, g1 in sorted(tr.trace.gaps):  # both lists sorted and disjoint: one sweep
        while j < len(inside) and inside[j][1] <= g0:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < g1:
            covered += min(g1, inside[k][1]) - max(g0, inside[k][0])
            k += 1
    return 100.0 * covered / idle
