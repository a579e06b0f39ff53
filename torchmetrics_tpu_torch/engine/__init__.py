"""Engine layer of the port.

- the compiled update engine: ``CompiledUpdate`` (one metric's update as one CUDA
  graph replay per step, ``compiled.py``), ``FusedUpdate`` (a collection's group
  owners in one graph, ``fusion.py``), shape buckets (``bucketing.py``) and the
  policy (``config.py``: ``engine_context``, ``set_engine_enabled``);
- the riders every step carries when asked: the quarantine transaction and the
  fallback ladder (``txn.py``: ``quarantine_context``), the compensated two-sum
  (``numerics.py``: ``compensated_context``);
- the K-step scan queue (``scan.py``: ``scan_context``) and its background drains
  (``async_dispatch.py``: ``async_context``);
- the packed epoch sync, the cached compute and the fused sync-and-compute
  (``epoch.py``);
- reduction signatures for cross-metric fusion and the rider keys (``statespec.py``);
- the signature manifest, ``prewarm`` and the warm-replica handoff (``persist.py``:
  ``persist_context``, ``set_persist_dir``, ``warm_start``);
- the counters of all of them (``stats.py``: ``EngineStats``, ``engine_report``,
  ``reset_engine_stats``).
"""

from torchmetrics_tpu_torch.engine.async_dispatch import async_context, set_async_dispatch
from torchmetrics_tpu_torch.engine.compiled import CompiledUpdate
from torchmetrics_tpu_torch.engine.config import engine_context, engine_enabled, set_engine_enabled
from torchmetrics_tpu_torch.engine.fusion import FusedUpdate
from torchmetrics_tpu_torch.engine.numerics import compensated_context, set_compensated
from torchmetrics_tpu_torch.engine.persist import (
    PersistEnvelopeError,
    PersistIntegrityError,
    persist_context,
    persist_state,
    prewarm,
    set_persist_dir,
    warm_start,
)
from torchmetrics_tpu_torch.engine.scan import scan_context, set_scan_steps
from torchmetrics_tpu_torch.engine.stats import EngineStats, engine_report, reset_engine_stats
from torchmetrics_tpu_torch.engine.txn import QuarantinedBatchError, quarantine_context, set_quarantine_mode

__all__ = [
    "CompiledUpdate",
    "EngineStats",
    "FusedUpdate",
    "PersistEnvelopeError",
    "PersistIntegrityError",
    "QuarantinedBatchError",
    "async_context",
    "compensated_context",
    "engine_context",
    "engine_enabled",
    "engine_report",
    "persist_context",
    "persist_state",
    "prewarm",
    "quarantine_context",
    "reset_engine_stats",
    "scan_context",
    "set_async_dispatch",
    "set_compensated",
    "set_engine_enabled",
    "set_persist_dir",
    "set_quarantine_mode",
    "set_scan_steps",
    "warm_start",
]
