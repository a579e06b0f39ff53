"""Diagnostics of the port (counterpart of part of ``torchmetrics_tpu/diag/``).

- ``trace``: the flight recorder (``FlightRecorder``, ``TraceEvent``, ``record``,
  ``active_recorder``, ``clear_recorder``, ``diag_context``, ``attribute_retrace``;
  ``TORCHMETRICS_TPU_TRACE``), a copy of the JAX module. The fault-tolerant sync and
  the elastic snapshots (``parallel/``) record their events through it.
- ``costs.state_footprint``: the bytes a metric's or a collection's states hold.

The rest of the JAX package's ``diag/`` (histograms, the sentinel, telemetry, profiles,
the cross-rank timeline, lineage, the transfer guard) has no counterpart yet.
"""

from torchmetrics_tpu_torch.diag.trace import (
    FlightRecorder,
    TraceEvent,
    active_recorder,
    attribute_retrace,
    clear_recorder,
    diag_context,
    record,
)

__all__ = [
    "FlightRecorder",
    "TraceEvent",
    "active_recorder",
    "attribute_retrace",
    "clear_recorder",
    "diag_context",
    "record",
]
