"""Update engine: the median per ``update`` / ``forward`` call of the summed
``engine.stage`` spans, the states shielded and copied into the static buffers and the
batch copied into the static inputs before each replay."""

from cudabench.layer_metrics import _program_spans


def read(tr):
    return _program_spans.median_per_call(tr, ("update", "forward"), ("engine.stage",), 1e-3)
