"""Modular SDR metrics (counterpart of ``torchmetrics_tpu/audio/sdr.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.audio._mean_base import _MeanOfBatchValues
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)


class SignalDistortionRatio(_MeanOfBatchValues):
    """Average SDR (the distortion filter solved in float64: ``functional/audio/sdr.py``)."""

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(
            signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)
        )


class ScaleInvariantSignalDistortionRatio(_MeanOfBatchValues):
    """Average SI-SDR.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> round(float(si_sdr(preds, target)), 4)
        18.403
    """

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(
            scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        )
