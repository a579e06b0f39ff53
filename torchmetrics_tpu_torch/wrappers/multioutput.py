"""Multioutput wrapper (counterpart of ``torchmetrics_tpu/wrappers/multioutput.py``)."""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.metric import Metric


class MultioutputWrapper(Metric):
    """One deep copy of ``base_metric`` per output, each fed its slice of the inputs
    along ``output_dim``.

    Every tensor input is laid out output-major once per step (``movedim`` plus one
    copy when the slices are not contiguous), so each copy's slice is a contiguous
    block: one copy per input for all outputs, where slicing column by column would
    leave each curve kernel a strided column to copy.

    ``remove_nans``: a row with a NaN in any input's slice of an output is dropped for
    that output, as in the JAX package. The JAX package reads the host once per output;
    here the NaN mask of every output is built in one device pass and its per-output
    row counts are read once per step; the kept rows come from a stable sort of the
    mask, so they keep their order.

    The copies and the wrapper live on the base metric's device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import MultioutputWrapper
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = MultioutputWrapper(BinaryAccuracy(device="cpu"), num_outputs=2)
        >>> metric.update(torch.tensor([[1.0, 0.0], [0.0, 0.0]]), torch.tensor([[1, 1], [0, 0]]))
        >>> metric.compute().tolist()
        [1.0, 0.5]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
    ) -> None:
        super().__init__(device=base_metric.device)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _by_output(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` with the output axis first and each output's slice contiguous."""
        return x.movedim(self.output_dim, 0).contiguous()

    def _get_args_kwargs_by_output(self, *args: Any, **kwargs: Any) -> List[Tuple[List[Any], Dict[str, Any]]]:
        """Each output's (args, kwargs): its slice of every tensor input, NaN rows dropped
        when ``remove_nans``."""
        names = list(kwargs)
        inputs = [*args, *kwargs.values()]
        tensors = {i: self._by_output(x) for i, x in enumerate(inputs) if isinstance(x, torch.Tensor) and x.ndim}
        keep: Optional[Tuple[torch.Tensor, List[int]]] = None
        if self.remove_nans:
            # (outputs, rows): a row of an output holds a NaN in some input's slice
            nan_rows = None
            for t in tensors.values():
                if t.ndim > 1:  # (outputs, rows, ...): a 1-d input has no rows to drop
                    rows = torch.isnan(t).reshape(t.shape[0], t.shape[1], -1).any(-1)
                    nan_rows = rows if nan_rows is None else nan_rows | rows
            if nan_rows is not None:
                order = torch.argsort(nan_rows.to(torch.int8), dim=1, stable=True)
                keep = (order, (~nan_rows).sum(1).tolist())  # the one host read of the step
        out = []
        for o in range(len(self.metrics)):
            selected = []
            for i, x in enumerate(inputs):
                t = tensors.get(i)
                if t is None:
                    selected.append(x)
                    continue
                s = t[o]
                if keep is not None and s.ndim and keep[1][o] < s.shape[0]:
                    s = s.index_select(0, keep[0][o, : keep[1][o]])
                if not self.squeeze_outputs:
                    s = s.unsqueeze(self.output_dim % x.ndim)
                selected.append(s)
            out.append((selected[: len(args)], dict(zip(names, selected[len(args) :]))))
        return out

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update each copy with its output's slice."""
        for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs)):
            metric.update(*selected_args, **selected_kwargs)

    def compute(self) -> torch.Tensor:
        """The copies' values stacked along dim 0."""
        return torch.stack([m.compute() for m in self.metrics], 0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The copies' batch values stacked along dim 0."""
        results = [
            metric(*selected_args, **selected_kwargs)
            for metric, (selected_args, selected_kwargs) in zip(self.metrics, self._get_args_kwargs_by_output(*args, **kwargs))
        ]
        if results[0] is None:
            return None
        return torch.stack(results, 0)

    def reset(self) -> None:
        """Reset every copy."""
        for metric in self.metrics:
            metric.reset()
        super().reset()

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
