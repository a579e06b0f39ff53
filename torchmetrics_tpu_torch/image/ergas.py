"""Modular relative global dimensionless synthesis error (counterpart of ``torchmetrics_tpu/image/ergas.py``).

``cat`` lists of the batches; the value is computed over all of them at ``compute``.
Under the engine the update falls back, as a list state does in the JAX package.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.image.ergas import _ergas_compute, _ergas_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """Relative global dimensionless synthesis error (ERGAS).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import ErrorRelativeGlobalDimensionlessSynthesis
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> float(metric.compute()) > 0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    def __init__(
        self,
        ratio: Union[int, float] = 4,
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Keep one batch of image pairs."""
        preds, target = _ergas_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        """The value over every kept batch."""
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ergas_compute(preds, target, self.ratio, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
