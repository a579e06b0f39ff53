"""Per-class output dict wrapper (counterpart of ``torchmetrics_tpu/wrappers/classwise.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.metric import Metric


class ClasswiseWrapper(Metric):
    """Split a per-class metric value into a dict keyed ``<metric name>_<label>``.

    ``update`` and ``compute`` pass through to the wrapped metric unwrapped (no count,
    no cache of their own); the wrapper lives on the wrapped metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ClasswiseWrapper
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"), labels=["a", "b", "c"])
        >>> out = metric(torch.tensor([0, 1, 2, 0]), torch.tensor([0, 1, 1, 0]))
        >>> {k: round(float(v), 2) for k, v in sorted(out.items())}
        {'multiclassaccuracy_a': 1.0, 'multiclassaccuracy_b': 0.5, 'multiclassaccuracy_c': 0.0}
    """

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {metric}"
            )
        super().__init__(device=metric.device)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        self.metric = metric
        self.labels = labels
        self._update_count = 1

    def _convert(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The batch value as a labelled dict."""
        return self._convert(self.metric(*args, **kwargs))

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the wrapped metric."""
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The epoch value as a labelled dict."""
        return self._convert(self.metric.compute())

    def reset(self) -> None:
        """Reset the wrapped metric."""
        self.metric.reset()

    def _wrap_update(self, update: Any) -> Any:
        return update

    def _wrap_compute(self, compute: Any) -> Any:
        return compute
