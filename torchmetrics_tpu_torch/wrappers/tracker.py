"""MetricTracker: one copy of a metric per step (counterpart of ``torchmetrics_tpu/wrappers/tracker.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


class MetricTracker:
    """Track a metric (or collection) across steps or epochs.

    ``increment()`` starts a step with a fresh deep copy of the base metric; ``update`` /
    ``forward`` / ``compute`` act on the newest copy, ``compute_all`` stacks every
    step's value and ``best_metric`` reads them on the host to pick the best step. A
    copy drops the engine (``Metric.__getstate__``), so each step's metric captures its
    own graphs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MetricTracker, MeanMetric
        >>> tracker = MetricTracker(MeanMetric(device="cpu"))
        >>> for epoch_vals in ([1.0, 2.0], [3.0, 4.0]):
        ...     tracker.increment()
        ...     for v in epoch_vals:
        ...         tracker.update(torch.tensor(v))
        >>> [float(v) for v in tracker.compute_all()]
        [1.5, 3.5]
        >>> best, which = tracker.best_metric(return_step=True)
        >>> print(best, which)
        3.5 1
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        if isinstance(metric, Metric) and not isinstance(maximize, bool):
            raise ValueError("Argument `maximize` should be a single bool when `metric` is a single Metric")
        self.maximize = maximize
        self._metrics: List[Union[Metric, MetricCollection]] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of tracked steps."""
        return len(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __getitem__(self, idx: int) -> Union[Metric, MetricCollection]:
        return self._metrics[idx]

    def increment(self) -> None:
        """Start a new step with a fresh copy of the base metric."""
        self._increment_called = True
        self._metrics.append(deepcopy(self._base_metric))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """``forward`` on the current step's metric."""
        self._check_for_increment("forward")
        return self._metrics[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the current step's metric."""
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        """Compute the current step's metric."""
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """Every step's value stacked along dim 0 (a dict of stacks for a collection)."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        try:
            if isinstance(res[0], dict):
                return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
            if isinstance(res[0], list):
                return torch.stack([torch.stack([torch.as_tensor(r2) for r2 in r], dim=0) for r in res], 0)
            return torch.stack([torch.as_tensor(r) for r in res], dim=0)
        except TypeError:
            return res

    def reset(self) -> None:
        """Reset the current step's metric."""
        self._metrics[-1].reset()

    def reset_all(self) -> None:
        """Reset every tracked metric."""
        for metric in self._metrics:
            metric.reset()

    def best_metric(
        self, return_step: bool = False
    ) -> Union[
        None,
        float,
        Tuple[float, int],
        Tuple[None, None],
        Dict[str, Optional[float]],
        Tuple[Dict[str, Optional[float]], Dict[str, Optional[int]]],
    ]:
        """The best value over the steps (and its step), read on the host; ``maximize``
        per collection member when it is a list."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else len(res) * [self.maximize]
            value: Dict[str, Optional[float]] = {}
            idx: Dict[str, Optional[int]] = {}
            for i, (k, v) in enumerate(res.items()):
                try:
                    arr = v.detach().cpu().numpy()
                    best = int(arr.argmax(0) if maximize[i] else arr.argmin(0))
                    value[k] = float(arr[best])
                    idx[k] = best
                except (ValueError, TypeError) as error:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}:"
                        f"{error}. Returning `None` instead.",
                        UserWarning,
                    )
                    value[k] = None
                    idx[k] = None
            return (value, idx) if return_step else value
        try:
            arr = res.detach().cpu().numpy()
            best = int(arr.argmax(0) if self.maximize else arr.argmin(0))
            return (float(arr[best]), best) if return_step else float(arr[best])
        except (ValueError, TypeError, AttributeError) as error:
            rank_zero_warn(
                f"Encountered the following error when trying to get the best metric: {error}."
                " Returning `None` instead.",
                UserWarning,
            )
            return (None, None) if return_step else None

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        """Plot the tracked values over the steps."""
        from torchmetrics_tpu_torch.utilities.plot import plot_single_or_multi_val

        val = val if val is not None else [self._metrics[i].compute() for i in range(self.n_steps)]
        return plot_single_or_multi_val(val, ax=ax, name=self._base_metric.__class__.__name__)
