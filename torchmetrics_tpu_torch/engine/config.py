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
