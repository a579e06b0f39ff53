"""Epoch end, inside the program: the median ``api.compute`` root span of the window's
``compute`` calls: ``compute_ms`` without the caller's read of the values."""

from cudabench.layer_metrics import _program_spans


def read(tr):
    return _program_spans.median_per_call(tr, ("compute",), ("api.compute",), 1e-6)
