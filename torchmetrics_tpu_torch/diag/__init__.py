"""Diagnostics of the port (counterpart of ``torchmetrics_tpu/diag/``, under the JAX module
names), near-zero cost when off:

- ``trace``: the flight recorder (``FlightRecorder``, ``record``, ``diag_context``,
  ``attribute_retrace``; ``TORCHMETRICS_TPU_TRACE``). The engines record their
  dispatches, builds and rebuilds with an attributed cause, fallbacks, syncs and
  collectives (the kinds of the JAX ``EVENT_KINDS``).
- ``transfer_guard``: ``transfer_guard("strict" | "log")`` proves the hot loop reads
  nothing back to the host, on two layers: ``torch.cuda.set_sync_debug_mode`` on the
  card, Python wrappers of the tensor-to-host entry points everywhere;
  ``transfer_allowed`` marks the sanctioned boundaries.
- ``costs``: the ledger of built signatures (capture ms, graph pool bytes, static
  bytes) and ``state_footprint``.
- ``sentinel``: the in-graph health bitmask (NaN / ±Inf / overflow / negative count /
  poisoned input / precision loss), ORed across ranks by the packed sync, and the
  divergence-audit knob.
- ``report``: ``diag_report``, ``export_json``, ``export_chrome_trace``.
- ``profile``: the ``tm:<owner>:<kind>:<signature>`` attribution scopes and sampled
  completion probes on CUDA events (``profile_context``; ``TORCHMETRICS_TPU_PROFILE``).
- ``hist``: fixed-memory log-bucketed histograms per (owner, kind, series).
- ``timeline``: the cross-rank timeline merge and the packed-sync straggler detection.
- ``lineage``: per-owner watermarks, staleness, exclusions, spans and coverage stamps
  (``ValueProvenance``).

``slo`` and ``telemetry`` have no counterpart yet: they wait for the serving layer.
"""

from torchmetrics_tpu_torch.diag.costs import ledger_snapshot, reset_ledger, state_footprint
from torchmetrics_tpu_torch.diag.hist import histograms_snapshot, reset_histograms
from torchmetrics_tpu_torch.diag.lineage import (
    LINEAGE_HEADER,
    ValueProvenance,
    lineage_context,
    lineage_enabled,
    lineage_snapshot,
    observe_metric,
    provenance_of,
    reset_lineage,
    stalest_owner,
)
from torchmetrics_tpu_torch.diag.profile import (
    profile_context,
    profile_snapshot,
    set_profile_every_n,
    set_straggler_threshold_us,
    straggler_threshold_us,
)
from torchmetrics_tpu_torch.diag.report import diag_report, export_chrome_trace, export_json
from torchmetrics_tpu_torch.diag.sentinel import (
    SENTINEL_BITS,
    audit_context,
    read_sentinel,
    reset_sentinels,
    sentinel_context,
    sentinel_report,
)
from torchmetrics_tpu_torch.diag.timeline import merge_timelines
from torchmetrics_tpu_torch.diag.trace import (
    FlightRecorder,
    TraceEvent,
    active_recorder,
    attribute_retrace,
    clear_recorder,
    diag_context,
    record,
)
from torchmetrics_tpu_torch.diag.transfer_guard import TransferGuardError, transfer_allowed, transfer_guard

__all__ = [
    "LINEAGE_HEADER",
    "SENTINEL_BITS",
    "FlightRecorder",
    "TraceEvent",
    "TransferGuardError",
    "ValueProvenance",
    "active_recorder",
    "attribute_retrace",
    "audit_context",
    "clear_recorder",
    "diag_context",
    "diag_report",
    "export_chrome_trace",
    "export_json",
    "histograms_snapshot",
    "ledger_snapshot",
    "lineage_context",
    "lineage_enabled",
    "lineage_snapshot",
    "merge_timelines",
    "observe_metric",
    "profile_context",
    "profile_snapshot",
    "provenance_of",
    "read_sentinel",
    "record",
    "reset_histograms",
    "reset_ledger",
    "reset_lineage",
    "reset_sentinels",
    "sentinel_context",
    "sentinel_report",
    "set_profile_every_n",
    "set_straggler_threshold_us",
    "stalest_owner",
    "state_footprint",
    "straggler_threshold_us",
    "transfer_allowed",
    "transfer_guard",
]
