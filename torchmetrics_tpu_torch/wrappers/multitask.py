"""Multitask wrapper (counterpart of ``torchmetrics_tpu/wrappers/multitask.py``)."""

from __future__ import annotations

from typing import Any, Dict, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric


def _device_of(metric: Union[Metric, MetricCollection]) -> Any:
    if isinstance(metric, Metric):
        return metric.device
    return next(iter(metric.values(copy_state=False))).device


class MultitaskWrapper(Metric):
    """One metric (or collection) per task, fed from dicts of predictions and targets
    keyed by task. ``update`` and ``compute`` pass through unwrapped; the wrapper lives
    on the first task's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MultitaskWrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy, MulticlassAccuracy
        >>> metric = MultitaskWrapper({"cls": BinaryAccuracy(device="cpu"),
        ...                            "mc": MulticlassAccuracy(num_classes=3, average="micro", device="cpu")})
        >>> metric.update(
        ...     {"cls": torch.tensor([1.0, 0.0, 1.0, 1.0]), "mc": torch.tensor([0, 1, 2])},
        ...     {"cls": torch.tensor([1, 0, 0, 1]), "mc": torch.tensor([0, 1, 1])},
        ... )
        >>> {k: round(float(v), 2) for k, v in sorted(metric.compute().items())}
        {'cls': 0.75, 'mc': 0.67}
    """

    is_differentiable = False

    def __init__(self, task_metrics: Dict[str, Union[Metric, MetricCollection]]) -> None:
        self._check_task_metrics_type(task_metrics)
        super().__init__(device=_device_of(next(iter(task_metrics.values()))) if task_metrics else None)
        self.task_metrics = task_metrics

    @staticmethod
    def _check_task_metrics_type(task_metrics: Dict[str, Union[Metric, MetricCollection]]) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not (isinstance(metric, (Metric, MetricCollection))):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        """Update each task's metric with its (preds, target) pair."""
        if not self.task_metrics.keys() == task_preds.keys() == task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped `task_metrics`."
                f" Found task_preds.keys() = {task_preds.keys()}, task_targets.keys() = {task_targets.keys()} "
                f"and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])

    def compute(self) -> Dict[str, Any]:
        """Per-task results."""
        return {task_name: metric.compute() for task_name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        """Per-task batch values."""
        return {
            task_name: metric(task_preds[task_name], task_targets[task_name])
            for task_name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        """Reset every task's metric."""
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()

    def _wrap_update(self, update: Any) -> Any:
        return update

    def _wrap_compute(self, compute: Any) -> Any:
        return compute
