"""Metric API, inside the program: the median host time of one ``update`` / ``forward``
call by the program's own root spans (``api.update`` / ``api.forward``, summed where one
benchmark call makes several), aligned to the trace: ``host_enqueue_us`` from inside."""

from cudabench.layer_metrics import _program_spans


def read(tr):
    return _program_spans.median_per_call(tr, ("update", "forward"), ("api.update", "api.forward"), 1e-3)
