"""Running-window wrapper (counterpart of ``torchmetrics_tpu/wrappers/running.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.engine.compiled import is_static
from torchmetrics_tpu_torch.metric import Metric


def _owned(value: Any) -> Any:
    """``value`` as a ring slot may keep it: a copy of an engine's static buffer (the
    next replay of the base metric's graph writes that buffer in place), else itself."""
    return value.clone() if is_static(value) else value


class Running(Metric):
    """Compute a metric over a fixed running window of recent updates.

    Each base-metric state is registered ``window`` times as ring slots ``<state>_<i>``.
    ``update`` / ``forward`` run the base metric, move its state into the current slot
    and reset it; ``compute`` folds the occupied slots into the base metric with
    ``merge_state(..., incoming_count=1)`` (each slot holds one update) and computes.
    ``forward`` returns the batch value. ``reset`` rewinds the ring with the states.

    The wrapper holds an inner metric, so the update engine runs it eagerly; the base
    metric's own updates still take its graphs. After such an update the base state
    is the engine's static buffer, which the next replay overwrites, so a slot takes a
    copy of it: one clone per state per update, and only under the engine.

    The states and the slots live on the base metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import Running, SumMetric
        >>> metric = Running(SumMetric(device="cpu"), window=3)
        >>> for v in (1.0, 2.0, 3.0, 4.0):
        ...     _ = metric(torch.tensor(v))
        >>> float(metric.compute())  # sum over the trailing window {2, 3, 4}
        9.0
    """

    def __init__(self, base_metric: Metric, window: int = 5) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {base_metric}"
            )
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._num_vals_seen = 0

        for key in base_metric._defaults:
            for i in range(window):
                self.add_state(
                    name=key + f"_{i}", default=base_metric._defaults[key], dist_reduce_fx=base_metric._reductions[key]
                )

    def _fill_slot(self) -> None:
        """Move the base metric's state into the current ring slot and reset it."""
        val = self._num_vals_seen % self.window
        for key in self.base_metric._defaults:
            setattr(self, key + f"_{val}", _owned(getattr(self.base_metric, key)))
        self.base_metric.reset()
        self._num_vals_seen += 1

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the base metric, then snapshot its state into the current ring slot."""
        self.base_metric.update(*args, **kwargs)
        # the slot reads the base state: a queued update (engine/scan.py) folds in first,
        # or the slot would take the default state and the reset discard the step
        self.base_metric._drain_scan("observation:running-slot")
        self._fill_slot()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The base metric's batch value; its state goes into the current slot."""
        res = self.base_metric.forward(*args, **kwargs)
        self._fill_slot()
        # this override bypasses the wrapped update(), so count the update here
        self._update_count += 1
        self._computed = None
        return res

    def compute(self) -> Any:
        """Fold the occupied window slots into the base metric and compute."""
        for i in range(min(self._num_vals_seen, self.window)):
            self.base_metric.merge_state(
                {key: getattr(self, key + f"_{i}") for key in self.base_metric._defaults},
                incoming_count=1,
            )
        val = self.base_metric.compute()
        self.base_metric.reset()
        return val

    def reset(self) -> None:
        """Reset the ring and the base metric."""
        super().reset()
        self.base_metric.reset()
        self._num_vals_seen = 0

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
