"""Update engine, host path: the median host time of one ``update`` / ``forward`` call,
by the host clock around the call with no sync (the device may still be working)."""

from cudabench.harness.stats import median


def read(tr):
    spans = tr.calls()
    if not spans:
        return None
    return median([s.host_s for s in spans]) * 1e6
