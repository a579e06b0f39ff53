"""Functional audio metrics (counterpart of ``torchmetrics_tpu/functional/audio/__init__.py``)."""

from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

__all__ = [
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "signal_distortion_ratio",
    "complex_scale_invariant_signal_noise_ratio",
    "scale_invariant_signal_noise_ratio",
    "signal_noise_ratio",
]

if _PESQ_AVAILABLE:
    from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality  # noqa: F401

    __all__.append("perceptual_evaluation_speech_quality")

if _PYSTOI_AVAILABLE:
    from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility  # noqa: F401

    __all__.append("short_time_objective_intelligibility")
