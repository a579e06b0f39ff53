"""Epoch end: the median host time from ``compute()`` to its values on the host (the
``compute`` span plus the read that follows it), over the traced window's epochs."""

from cudabench.harness.stats import median


def read(tr):
    computes = tr.rec.of_kind("compute")
    reads = tr.rec.of_kind("epoch_read")
    if not computes or len(computes) != len(reads):
        return None
    return median([c.host_s + r.host_s for c, r in zip(computes, reads)]) * 1e3
