"""Wrappers that transform metrics (counterpart of ``torchmetrics_tpu/wrappers/``).

Each wrapper holds inner metrics, so the update engine runs the wrapper itself eagerly
(a fallback counted as ``stateless`` or ``nested-metric`` where its ``update`` is
wrapped); the inner metrics take their own engine steps.
"""

from torchmetrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from torchmetrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from torchmetrics_tpu_torch.wrappers.minmax import MinMaxMetric
from torchmetrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from torchmetrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from torchmetrics_tpu_torch.wrappers.running import Running
from torchmetrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = [
    "BootStrapper",
    "ClasswiseWrapper",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
]
