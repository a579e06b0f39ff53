"""Modular STOI (counterpart of ``torchmetrics_tpu/audio/stoi.py``)."""

from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.audio._mean_base import _MeanOfBatchValues
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from torchmetrics_tpu_torch.utilities.imports import _PYSTOI_AVAILABLE


class ShortTimeObjectiveIntelligibility(_MeanOfBatchValues):
    """Average STOI through the ``pystoi`` package (host DSP)."""

    is_differentiable = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PYSTOI_AVAILABLE:
            raise ModuleNotFoundError(
                "ShortTimeObjectiveIntelligibility metric requires that `pystoi` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pystoi`."
            )
        self.fs = fs
        self.extended = extended

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(short_time_objective_intelligibility(preds, target, self.fs, self.extended, False))
