"""Metric API: the median per ``update`` / ``forward`` call of the summed ``eager.update``
spans, the members that fell back from the engine and ran their update eagerly."""

from cudabench.layer_metrics import _program_spans


def read(tr):
    return _program_spans.median_per_call(tr, ("update", "forward"), ("eager.update",), 1e-3)
