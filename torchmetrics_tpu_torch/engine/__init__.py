"""Engine layer of the port.

- the compiled update engine: ``CompiledUpdate`` (one metric's update as one CUDA
  graph replay per step, ``compiled.py``), ``FusedUpdate`` (a collection's group
  owners in one graph, ``fusion.py``), shape buckets (``bucketing.py``) and the
  policy (``config.py``: ``engine_context``, ``set_engine_enabled``);
- the packed epoch sync (``epoch.py``);
- reduction signatures for cross-metric fusion (``statespec.py``);
- the counters of both (``stats.py``: ``EngineStats``, ``engine_report``,
  ``reset_engine_stats``).
"""

from torchmetrics_tpu_torch.engine.compiled import CompiledUpdate
from torchmetrics_tpu_torch.engine.config import engine_context, engine_enabled, set_engine_enabled
from torchmetrics_tpu_torch.engine.fusion import FusedUpdate
from torchmetrics_tpu_torch.engine.stats import EngineStats, engine_report, reset_engine_stats

__all__ = [
    "CompiledUpdate",
    "EngineStats",
    "FusedUpdate",
    "engine_context",
    "engine_enabled",
    "engine_report",
    "reset_engine_stats",
    "set_engine_enabled",
]
