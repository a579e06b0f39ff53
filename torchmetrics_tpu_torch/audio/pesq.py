"""Modular PESQ (counterpart of ``torchmetrics_tpu/audio/pesq.py``)."""

from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.audio._mean_base import _MeanOfBatchValues
from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE


class PerceptualEvaluationSpeechQuality(_MeanOfBatchValues):
    """Average PESQ through the ``pesq`` package (host DSP)."""

    is_differentiable = False
    plot_lower_bound = -0.5
    plot_upper_bound = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that `pesq` is installed."
                " Either install as `pip install torchmetrics[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.n_processes = n_processes

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self._update_from_values(
            perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, False, self.n_processes)
        )
