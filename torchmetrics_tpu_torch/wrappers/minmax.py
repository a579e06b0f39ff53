"""Min / max tracking wrapper (counterpart of ``torchmetrics_tpu/wrappers/minmax.py``)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.metric import Metric


class MinMaxMetric(Metric):
    """Track the min and max of a scalar metric's value across ``compute`` calls.

    ``min_val`` / ``max_val`` are plain attributes, not states, on the base metric's
    device unless ``device=`` says otherwise: ``reset`` resets the base metric and
    leaves them as they are, as in the JAX package (so the full-state ``forward``, whose
    mid-step reset would otherwise clear them, tracks per-batch extrema).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MinMaxMetric
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> _ = metric(torch.tensor([1.0, 0.0, 1.0]), torch.tensor([1, 0, 0]))
        >>> _ = metric(torch.tensor([1.0, 0.0, 1.0]), torch.tensor([1, 0, 1]))
        >>> print({k: round(float(v), 4) for k, v in sorted(metric.compute().items())})
        {'max': 1.0, 'min': 0.6667, 'raw': 1.0}
    """

    full_state_update: Optional[bool] = True
    min_val: torch.Tensor
    max_val: torch.Tensor

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `torchmetrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.min_val = torch.tensor(math.inf, device=self.device)
        self.max_val = torch.tensor(-math.inf, device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the base metric."""
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        """``{"raw", "min", "max"}``: the base value, with the extrema updated by it."""
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        v = torch.as_tensor(val, device=self.device)
        self.max_val = torch.where(self.max_val < v, v, self.max_val)
        self.min_val = torch.where(self.min_val > v, v, self.min_val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def reset(self) -> None:
        """Reset the base metric, not the tracked extrema."""
        super().reset()
        self._base_metric.reset()

    @staticmethod
    def _is_suitable_val(val: Union[float, torch.Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        return False

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
