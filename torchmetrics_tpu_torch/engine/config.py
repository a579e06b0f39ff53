"""Engine enablement and policy knobs (counterpart of ``torchmetrics_tpu/engine/config.py``).

Resolution order for "is the engine on?" (first hit wins):

1. per-metric ``Metric(compiled_update=True/False)``: handled by the caller;
2. an active :func:`engine_context` / :func:`set_engine_enabled` override;
3. the ``TORCHMETRICS_TPU_ENGINE`` environment variable (``"1"`` / ``"0"``);
4. auto: on when the metric's device is a CUDA device, off on the CPU. On the CPU the
   per-operation dispatch the engine removes costs microseconds, as in the JAX
   package, where the engine is off on a CPU backend.

The JAX package's donation switch has no counterpart: a step always writes the new
state into the engine's static state buffers in place and leaves them on the metric
(``engine/compiled.py``), on the card and on the CPU alike.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Generator, Optional

ENGINE_ENV_VAR = "TORCHMETRICS_TPU_ENGINE"

#: every environment knob of the engine, sync and diagnostics layers, mapped to the
#: ``module:function`` that parses it (an invalid value raises there), as the JAX
#: package's registry maps its own
KNOB_REGISTRY = {
    "TORCHMETRICS_TPU_ENGINE": "torchmetrics_tpu_torch.engine.config:engine_enabled",
    "TORCHMETRICS_TPU_CSE": "torchmetrics_tpu_torch.engine.statespec:cse_enabled",
    "TORCHMETRICS_TPU_SCAN": "torchmetrics_tpu_torch.engine.scan:scan_k",
    "TORCHMETRICS_TPU_ASYNC": "torchmetrics_tpu_torch.engine.async_dispatch:async_inflight",
    "TORCHMETRICS_TPU_QUARANTINE": "torchmetrics_tpu_torch.engine.txn:quarantine_mode",
    "TORCHMETRICS_TPU_COMPENSATED": "torchmetrics_tpu_torch.engine.numerics:compensated_enabled",
    "TORCHMETRICS_TPU_DRIFT_RTOL": "torchmetrics_tpu_torch.engine.numerics:drift_rtol",
    "TORCHMETRICS_TPU_SHARD": "torchmetrics_tpu_torch.parallel.sharding:_env_mesh",
    "TORCHMETRICS_TPU_PERSIST": "torchmetrics_tpu_torch.engine.persist:persist_dir",
    "TORCHMETRICS_TPU_MULTIHOST": "torchmetrics_tpu_torch.parallel.sharding:multihost_spec",
    "TORCHMETRICS_TPU_SYNC_DEADLINE_MS": "torchmetrics_tpu_torch.parallel.resilience:_env_float",
    "TORCHMETRICS_TPU_SYNC_RETRIES": "torchmetrics_tpu_torch.parallel.resilience:_env_float",
    "TORCHMETRICS_TPU_SYNC_BACKOFF_MS": "torchmetrics_tpu_torch.parallel.resilience:_env_float",
    "TORCHMETRICS_TPU_DEGRADED": "torchmetrics_tpu_torch.parallel.resilience:current_policy",
    "TORCHMETRICS_TPU_SNAPSHOT_EVERY": "torchmetrics_tpu_torch.parallel.elastic:SnapshotPolicy.from_env",
    "TORCHMETRICS_TPU_COSTS": "torchmetrics_tpu_torch.diag.costs:costs_enabled",
    "TORCHMETRICS_TPU_TRACE": "torchmetrics_tpu_torch.diag.trace:_env_recorder",
    "TORCHMETRICS_TPU_SENTINEL": "torchmetrics_tpu_torch.diag.sentinel:sentinel_enabled",
    "TORCHMETRICS_TPU_AUDIT": "torchmetrics_tpu_torch.diag.sentinel:audit_enabled",
    "TORCHMETRICS_TPU_PROFILE": "torchmetrics_tpu_torch.diag.profile:active_profile",
    "TORCHMETRICS_TPU_STRAGGLER_US": "torchmetrics_tpu_torch.diag.profile:straggler_threshold_us",
}

# module-level override: None = defer to the environment variable / auto
_enabled_override: Optional[bool] = None

# bucketing policy (see engine/bucketing.py)
BUCKETING_ENABLED = True
MIN_BUCKET = 8


def engine_enabled(device=None) -> bool:
    """Whether the compiled update engine engages for metrics on ``device`` that have
    no per-metric override (``None``: whether CUDA is available)."""
    if _enabled_override is not None:
        return _enabled_override
    env = os.environ.get(ENGINE_ENV_VAR)
    if env is not None and env.strip() in ("0", "1"):
        return env.strip() == "1"
    if device is None:
        import torch

        return torch.cuda.is_available()
    return getattr(device, "type", str(device)) == "cuda"


def set_engine_enabled(value: Optional[bool]) -> None:
    """Force the engine on/off process-wide; ``None`` restores auto resolution."""
    global _enabled_override
    if value is not None and not isinstance(value, bool):
        raise ValueError(f"Expected `value` to be a bool or None but got {value}")
    _enabled_override = value


@contextmanager
def engine_context(enabled: bool = True) -> Generator:
    """Scoped engine enablement: the tests and ``chip_smoke.py`` use this."""
    global _enabled_override
    prev = _enabled_override
    _enabled_override = enabled
    try:
        yield
    finally:
        _enabled_override = prev
