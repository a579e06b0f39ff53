"""Modular Kendall rank correlation (counterpart of ``torchmetrics_tpu/regression/kendall.py``).

The raw values go into ``cat`` list states; the blocked pair scan runs in ``compute``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.kendall import (
    _kendall_corrcoef_compute,
    _kendall_corrcoef_update,
    _MetricVariant,
    _TestAlternative,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class KendallRankCorrCoef(Metric):
    """Kendall's tau (variants a, b and c), and its p-value when ``t_test``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import KendallRankCorrCoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> metric = KendallRankCorrCoef(device="cpu")
        >>> metric.update(preds, target)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = -1.0
    plot_upper_bound: float = 1.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(
        self,
        variant: str = "b",
        t_test: bool = False,
        alternative: Optional[str] = "two-sided",
        num_outputs: int = 1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(t_test, bool):
            raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {type(t_test)}.")
        if t_test and alternative is None:
            raise ValueError("Argument `alternative` is required if `t_test=True` but got `None`.")
        self.variant = _MetricVariant.from_str(str(variant))
        self.alternative = _TestAlternative.from_str(str(alternative)) if t_test else None
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Append one batch of raw values."""
        preds, target = _kendall_corrcoef_update(preds, target, self.num_outputs)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Tau (and the p-value when ``t_test``) over the whole stream."""
        tau, p_value = _kendall_corrcoef_compute(
            dim_zero_cat(self.preds), dim_zero_cat(self.target), self.variant, self.alternative
        )
        if p_value is not None:
            return tau, p_value
        return tau

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
