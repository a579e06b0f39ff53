"""Fixed-memory log-bucketed latency and size histograms (counterpart of
``torchmetrics_tpu/diag/hist.py``, copied: it imports neither JAX nor torch).

Each histogram is a fixed array of integer bucket counts over geometrically spaced
bounds, so recording is one ``bisect`` and one increment, a million samples cost the
bytes of ten, and quantiles come with a bounded relative error.

Bucket scheme: bounds grow by ``GROWTH = 2**(1/4)`` (four sub-buckets per octave) over
``2**-2 .. 2**30`` (0.25 µs to ~18 minutes for latencies, 0.25 B to 1 GiB for sizes).
The counts array has 130 slots: one per bound (values at or below the first bound share
bucket 0) plus one overflow slot. A quantile estimate is the upper bound of the bucket
holding that rank, so for an in-range sample quantile ``q``:
``q <= estimate <= q * GROWTH``, a one-sided relative error of at most 18.92 %.

Histograms live in a process-wide registry keyed by ``(owner, kind, series)`` (say
``("fused:...", "fused", "dispatch_us")``). The engines feed them only while something
observes (an active flight recorder or profile scope), so the unobserved hot loop pays
nothing. Series names end in their unit (``_us``, ``_bytes``).
``engine/stats.reset_engine_stats`` calls ``reset_histograms`` in lockstep with the
counters.
"""

from __future__ import annotations

from bisect import bisect_left
from math import ceil
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "BOUNDS",
    "GROWTH",
    "Histogram",
    "hist_from_arrays",
    "hist_to_arrays",
    "histograms_snapshot",
    "merge_hists",
    "observe",
    "reset_histograms",
]

#: per-bucket growth factor: 4 sub-buckets per octave => <= 2**(1/4)-1 ~ 18.92%
#: one-sided relative quantile error
GROWTH = 2.0 ** 0.25

#: geometric bucket upper bounds, 2**-2 .. 2**30 in quarter-octave steps
#: (129 boundaries; +1 overflow slot). Shared by every histogram — boundaries
#: are class-level constants, per-instance memory is the counts array only.
BOUNDS: Tuple[float, ...] = tuple(2.0 ** (i / 4.0) for i in range(-8, 121))

_N = len(BOUNDS)  # counts array length is _N + 1 (last slot = overflow)


class Histogram:
    """One fixed-memory log-bucketed histogram (counts + sum + min/max)."""

    __slots__ = ("counts", "total", "sum", "min", "max")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * (_N + 1)
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, value: float) -> None:
        """O(log buckets): one bisect + one increment. Never raises."""
        v = float(value)
        if v != v:  # NaN would silently poison sum/min/max
            return
        # bisect_left on the shared boundary tuple: first bound >= v; values
        # past the top land in the overflow slot, <= 2**-2 in bucket 0
        self.counts[bisect_left(BOUNDS, v)] += 1
        self.total += 1
        self.sum += v
        self.min = v if self.min is None or v < self.min else self.min
        self.max = v if self.max is None or v > self.max else self.max

    def quantile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the ``q``-quantile sample.

        Rank convention matches ``sorted(samples)[ceil(q * n) - 1]`` (the
        "higher" interpolation), so for any recorded sample the estimate is
        within ``[exact, exact * GROWTH]`` while the sample is in bucket
        range; overflow-bucket ranks return the recorded ``max`` (exact-free
        but honest — better than pretending the top boundary was the tail).
        """
        if self.total == 0:
            return None
        rank = min(self.total, max(1, ceil(q * self.total)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return BOUNDS[i] if i < _N else self.max
        return self.max  # unreachable: cum == total >= rank

    def nonempty_buckets(self) -> List[Tuple[Optional[float], int]]:
        """Cumulative ``(upper_bound, cumulative_count)`` pairs at non-empty
        buckets; the final pair's bound is ``None`` (the +Inf bucket)."""
        out: List[Tuple[Optional[float], int]] = []
        cum = 0
        for i, c in enumerate(self.counts):
            if c:
                cum += c
                out.append((BOUNDS[i] if i < _N else None, cum))
        if not out or out[-1][0] is not None:
            out.append((None, cum))
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {
            "count": self.total,
            "sum": round(self.sum, 3),
            "min": self.min,
            "max": self.max,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }

    def __repr__(self) -> str:
        return f"Histogram(n={self.total}, p50={self.quantile(0.5)}, p99={self.quantile(0.99)})"


def merge_hists(a: Histogram, b: Histogram) -> Histogram:
    """Merge two histograms over the shared geometric bounds.

    Every histogram shares the class-level :data:`BOUNDS`, so the merge is an
    elementwise register (bucket-count) addition plus the scalar folds —
    commutative and associative, and exactly the histogram the union stream
    would have produced (each sample lands in the same bucket regardless of
    which pod recorded it). The quantile error bound is therefore unchanged by
    merging: a merged estimate stays within ``[exact, exact * GROWTH]`` for
    in-range samples.
    """
    out = Histogram()
    out.counts = [x + y for x, y in zip(a.counts, b.counts)]
    out.total = a.total + b.total
    out.sum = a.sum + b.sum
    mins = [m for m in (a.min, b.min) if m is not None]
    maxs = [m for m in (a.max, b.max) if m is not None]
    out.min = min(mins) if mins else None
    out.max = max(maxs) if maxs else None
    return out


def hist_to_arrays(hist: Histogram) -> Tuple[List[int], List[float]]:
    """Flatten a histogram into ``(counts, [total, sum, min, max])`` lists.

    The wire form of a histogram between processes: the counts ride as one fixed-length integer vector over the shared
    :data:`BOUNDS`, the scalar folds as a 4-float vector with NaN standing in
    for an unset min/max. Round-trips exactly through
    :func:`hist_from_arrays` — bucket geometry is a class-level constant, so
    no boundary data travels and a merged remote histogram keeps the same
    ≤ 18.92% one-sided quantile error bound as a local one.
    """
    nan = float("nan")
    meta = [
        float(hist.total),
        float(hist.sum),
        nan if hist.min is None else float(hist.min),
        nan if hist.max is None else float(hist.max),
    ]
    return list(hist.counts), meta


def hist_from_arrays(counts, meta) -> Histogram:
    """Rebuild a :class:`Histogram` from its :func:`hist_to_arrays` form."""
    counts = [int(c) for c in counts]
    if len(counts) != _N + 1:
        raise ValueError(
            f"histogram counts vector has {len(counts)} slots, expected {_N + 1}"
            " — incompatible bucket layout"
        )
    hist = Histogram()
    hist.counts = counts
    hist.total = int(meta[0])
    hist.sum = float(meta[1])
    hist.min = None if float(meta[2]) != float(meta[2]) else float(meta[2])
    hist.max = None if float(meta[3]) != float(meta[3]) else float(meta[3])
    return hist


# process-wide registry: (owner, kind, series) -> Histogram. Bounded by the
# live (owner, kind) population x ~5 series names — not by event volume.
_REGISTRY: Dict[Tuple[str, str, str], Histogram] = {}


def observe(owner: str, kind: str, series: str, value: float) -> None:
    """Record one sample into the ``(owner, kind, series)`` histogram.

    Call sites gate on "is anything observing" (active recorder or active
    profile scope) — this function itself always records.
    """
    hist = _REGISTRY.get((owner, kind, series))
    if hist is None:
        hist = _REGISTRY[(owner, kind, series)] = Histogram()
    hist.record(value)


def histograms_snapshot() -> List[Dict[str, Any]]:
    """Every live histogram as a sorted row (byte-stable JSON ordering)."""
    return [
        {"owner": owner, "kind": kind, "series": series, **hist.as_dict()}
        for (owner, kind, series), hist in sorted(_REGISTRY.items())
    ]


def histogram_items() -> List[Tuple[Tuple[str, str, str], Histogram]]:
    """Sorted live ``((owner, kind, series), Histogram)`` pairs (exporter use)."""
    return sorted(_REGISTRY.items())


def reset_histograms() -> None:
    """Drop every histogram (``reset_engine_stats`` calls this in lockstep)."""
    _REGISTRY.clear()
