"""Modular perplexity (counterpart of ``torchmetrics_tpu/text/perplexity.py``): a float32
Σ -log p sum and an int32 token count, both updated on the device."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update
from torchmetrics_tpu_torch.metric import Metric


class Perplexity(Metric):
    """Perplexity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> logits = torch.log(torch.tensor([[[0.7, 0.1, 0.2], [0.25, 0.5, 0.25]],
        ...                                  [[0.1, 0.1, 0.8], [0.3, 0.4, 0.3]]]))
        >>> target = torch.tensor([[0, 1], [2, 1]])
        >>> perp = Perplexity(device="cpu")
        >>> print(round(float(perp(logits, target)), 2))
        1.73
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", 0.0, dist_reduce_fx="sum")
        self.add_state("count", 0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the negative log-likelihood and the token count of one batch."""
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total_log_probs
        self.count = self.count + count

    def compute(self) -> torch.Tensor:
        """Perplexity over all tokens."""
        return _perplexity_compute(self.total_log_probs, self.count)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
