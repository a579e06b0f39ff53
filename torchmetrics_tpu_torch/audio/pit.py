"""Modular permutation-invariant training (counterpart of ``torchmetrics_tpu/audio/pit.py``)."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from torchmetrics_tpu_torch.audio._mean_base import _MeanOfBatchValues
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training


class PermutationInvariantTraining(_MeanOfBatchValues):
    """Average best-permutation metric value; the keyword arguments that are not Metric
    options go to ``metric_func``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> target = torch.sin(torch.arange(200.0)[None, None] * torch.tensor([0.1, 0.3])[None, :, None])
        >>> preds = target.flip(1) + 0.01 * torch.cos(torch.arange(200.0))
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
        >>> round(float(pit(preds, target)), 2)
        39.92
    """

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        # every Metric option goes to the base; the rest feed metric_func
        _metric_option_names = (
            "compute_on_cpu",
            "dist_sync_on_step",
            "process_group",
            "dist_sync_fn",
            "distributed_available_fn",
            "sync_on_compute",
            "compute_with_cache",
            "device",
        )
        base_kwargs: Dict[str, Any] = {name: kwargs.pop(name) for name in _metric_option_names if name in kwargs}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        best_metric = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )[0]
        self._update_from_values(best_metric)
