"""Aggregators of value streams with a NaN policy (counterpart of ``torchmetrics_tpu/aggregation.py``).

``nan_strategy``: ``"error"`` raises on a NaN, ``"warn"`` warns and removes NaNs,
``"ignore"`` removes them silently, and a float replaces them (``torch.nan_to_num``,
which also maps +-inf to the dtype's finite extremes, as ``jnp.nan_to_num`` does).

The first three read the host once per tensor input to test for NaNs (a removal
reads it again: a boolean mask sizes its output), as the JAX package does, so under
the update engine they are eager fallbacks counted as host reads. A float strategy
reads nothing: ``SumMetric``, ``MeanMetric``, ``MaxMetric`` and ``MinMetric`` with one
replay their update as a graph. ``CatMetric``'s list state always falls back. A finite
Python number (``MeanMetric``'s default weight of 1.0) is tested on the host and made
a device scalar with ``torch.full``, which a graph can hold.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.running import Running


class BaseAggregator(Metric):
    """One ``value`` state reduced by ``fn``, and the NaN policy of the inputs.

    Args:
        fn: the state's ``dist_reduce_fx``.
        default_value: the state's default.
        nan_strategy: ``"error"``, ``"warn"``, ``"ignore"`` or a float.
        kwargs: ``Metric`` keyword arguments (``device=`` among them).
    """

    value: torch.Tensor
    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[torch.Tensor, List],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy}"
                f" but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _cast_and_nan_check_input(self, x: Union[float, torch.Tensor]) -> torch.Tensor:
        """To a float32 tensor on the metric's device, with the NaN policy applied."""
        if isinstance(x, (int, float)) and math.isfinite(x):
            return torch.full((), x, dtype=torch.float32, device=self.device)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if isinstance(self.nan_strategy, float):
            return torch.nan_to_num(x, nan=self.nan_strategy)
        nans = torch.isnan(x)
        if nans.any():  # a host read
            if self.nan_strategy == "error":
                raise RuntimeError("Encounted `nan` values in tensor")
            if self.nan_strategy == "warn":
                rank_zero_warn("Encounted `nan` values in tensor. Will be removed.", UserWarning)
            x = x.flatten()[~nans.flatten()]
        return x

    def update(self, value: Union[float, torch.Tensor]) -> None:
        """Overwrite in child class."""

    def compute(self) -> torch.Tensor:
        """Return the aggregated value."""
        return self.value

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class MaxMetric(BaseAggregator):
    """Running max of a value stream.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(metric.compute())
        3.0
    """

    full_state_update: bool = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-math.inf, dtype=torch.float32), nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        """Fold the batch max into the state."""
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = torch.maximum(self.value, value.max())


class MinMetric(BaseAggregator):
    """Running min of a value stream.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 3.0, 2.0]))
        >>> float(metric.compute())
        1.0
    """

    full_state_update: bool = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(math.inf, dtype=torch.float32), nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        """Fold the batch min into the state."""
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = torch.minimum(self.value, value.min())


class SumMetric(BaseAggregator):
    """Running sum of a value stream.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> float(metric.compute())
        6.0
    """

    #: the update is additive in its sum-reduced state (``new = old + g(batch)``): the
    #: compensated accumulation (``engine/numerics.py``) may run it on a zeroed state
    _engine_state_additive = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0, dtype=torch.float32), nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        """Add the batch sum to the state."""
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value = self.value + value.sum()


class CatMetric(BaseAggregator):
    """Concatenation of every value seen (a list state).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> metric.update(3.0)
        >>> metric.compute().tolist()
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        """Append the batch values."""
        value = self._cast_and_nan_check_input(value)
        if value.numel():
            self.value.append(value)

    def compute(self) -> torch.Tensor:
        """The concatenated values."""
        if isinstance(self.value, list) and self.value:
            return torch.cat([v.reshape(1) if v.ndim == 0 else v for v in self.value])
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean: ``weight`` broadcasts to ``value``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(torch.tensor([2.0, 3.0]))
        >>> float(metric.compute())
        2.0
    """

    weight: torch.Tensor

    #: additive in both sum-reduced states: compensation-eligible (``engine/numerics.py``)
    _engine_state_additive = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0, dtype=torch.float32), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0, dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value: Union[float, torch.Tensor], weight: Union[float, torch.Tensor] = 1.0) -> None:
        """Add the weighted sum and the total weight.

        The NaN policy strips ``value`` and ``weight`` each on its own, as the JAX
        package does: a value with NaNs removed beside a full-size weight does not
        broadcast and raises.
        """
        value = self._cast_and_nan_check_input(value)
        weight = self._cast_and_nan_check_input(weight)
        if value.numel() == 0:
            return
        weight = torch.broadcast_to(weight, value.shape)
        self.value = self.value + (value * weight).sum()
        self.weight = self.weight + weight.sum()

    def compute(self) -> torch.Tensor:
        """The weighted mean."""
        return self.value / self.weight


class RunningMean(Running):
    """Mean over a running window of the last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningMean
        >>> metric = RunningMean(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 6.0):
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        4.0
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=MeanMetric(nan_strategy=nan_strategy, **kwargs), window=window)


class RunningSum(Running):
    """Sum over a running window of the last ``window`` updates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import RunningSum
        >>> metric = RunningSum(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 6.0):
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())
        8.0
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=SumMetric(nan_strategy=nan_strategy, **kwargs), window=window)
