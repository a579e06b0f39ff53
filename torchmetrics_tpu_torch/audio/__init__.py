"""Audio metrics (counterpart of ``torchmetrics_tpu/audio/__init__.py``)."""

from torchmetrics_tpu_torch.audio.pit import PermutationInvariantTraining
from torchmetrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio
from torchmetrics_tpu_torch.audio.snr import (
    ComplexScaleInvariantSignalNoiseRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalNoiseRatio,
)
from torchmetrics_tpu_torch.utilities.imports import _PESQ_AVAILABLE, _PYSTOI_AVAILABLE

__all__ = [
    "ComplexScaleInvariantSignalNoiseRatio",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
]

if _PESQ_AVAILABLE:
    from torchmetrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality  # noqa: F401

    __all__.append("PerceptualEvaluationSpeechQuality")

if _PYSTOI_AVAILABLE:
    from torchmetrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility  # noqa: F401

    __all__.append("ShortTimeObjectiveIntelligibility")
