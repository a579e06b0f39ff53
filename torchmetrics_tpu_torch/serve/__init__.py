"""The serving plane on the card (counterpart of ``torchmetrics_tpu/serve/``, under the
JAX module names): continuous-traffic evaluation without host transfers in the
update loop.

- ``window``: :class:`WindowedMetric` (a ring of partial states; advance, evict and
  fold in one step) and :class:`DecayedMetric` (EMA states) over any sum / max / min
  base metric;
- ``sketch``: :class:`CardinalitySketch` (HyperLogLog, max-merge) and
  :class:`HeavyHitters` (count-min with a top-k on the card);
- ``quantile``: :class:`KLLSketch`, a mergeable deterministic quantile sketch;
- ``tenancy``: :class:`TenantSlices`, bounded per-tenant slices sharing one captured
  graph (the tenant id is data), spilling to a heavy-hitter sketch;
  :func:`federated_rollup` folds per-pod views by tenant id;
- ``snapshot``: :func:`snapshot_compute`, ``compute()`` on a stream-ordered copy of
  the state while updates go on;
- ``sidecar``: :class:`MetricsSidecar`, the exporters behind a threaded scrape
  endpoint, with the ``/state`` envelope;
- ``federation``: :class:`FederationAggregator`, verified pod envelopes folded in
  canonical order through the packed-sync plan, degraded at pod loss;
- ``fleet``: :class:`FleetTelemetry`, the pods' telemetry envelopes merged, exposed
  and held to the SLOs of ``diag/slo.py``.
"""

from torchmetrics_tpu_torch.serve.federation import FederationAggregator, pack_envelope, parse_envelope
from torchmetrics_tpu_torch.serve.fleet import FleetTelemetry, pack_telemetry, parse_telemetry
from torchmetrics_tpu_torch.serve.quantile import KLLSketch
from torchmetrics_tpu_torch.serve.sidecar import MetricsSidecar
from torchmetrics_tpu_torch.serve.sketch import CardinalitySketch, HeavyHitters
from torchmetrics_tpu_torch.serve.snapshot import StateSnapshot, snapshot_compute, take_snapshot
from torchmetrics_tpu_torch.serve.stats import reset_serve_stats, serve_state
from torchmetrics_tpu_torch.serve.tenancy import TenantSlices, federated_rollup
from torchmetrics_tpu_torch.serve.window import DecayedMetric, WindowedMetric

__all__ = [
    "CardinalitySketch",
    "DecayedMetric",
    "FederationAggregator",
    "FleetTelemetry",
    "HeavyHitters",
    "KLLSketch",
    "MetricsSidecar",
    "StateSnapshot",
    "TenantSlices",
    "WindowedMetric",
    "federated_rollup",
    "pack_envelope",
    "pack_telemetry",
    "parse_envelope",
    "parse_telemetry",
    "reset_serve_stats",
    "serve_state",
    "snapshot_compute",
    "take_snapshot",
]
