"""Modular SNR metrics (counterpart of ``torchmetrics_tpu/audio/snr.py``)."""

from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.audio._mean_base import _MeanOfBatchValues
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)


class SignalNoiseRatio(_MeanOfBatchValues):
    """Average SNR over all seen samples.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> round(float(snr(preds, target)), 4)
        16.1805
    """

    plot_lower_bound = None
    plot_upper_bound = None

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean))


class ScaleInvariantSignalNoiseRatio(_MeanOfBatchValues):
    """Average SI-SNR."""

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(scale_invariant_signal_noise_ratio(preds=preds, target=target))


class ComplexScaleInvariantSignalNoiseRatio(_MeanOfBatchValues):
    """Average C-SI-SNR over complex spectra (or real ones with a trailing axis of 2)."""

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(
            complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        )
