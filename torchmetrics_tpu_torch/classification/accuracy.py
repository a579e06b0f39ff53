"""Modular multiclass accuracy (counterpart of ``torchmetrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce


class MulticlassAccuracy(MulticlassStatScores):
    """Accuracy for multiclass tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0.1, 0.8, 0.1], [0.7, 0.2, 0.1], [0.2, 0.2, 0.6]])
        >>> float(metric(preds, torch.tensor([1, 0, 1])))
        0.5
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def compute(self) -> torch.Tensor:
        """Averaged accuracy over the accumulated state."""
        tp, fp, tn, fn = self._final_state()
        return _accuracy_reduce(tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average)
