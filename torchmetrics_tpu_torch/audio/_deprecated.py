"""Root aliases of the audio metrics, which warn at construction (counterpart of
``torchmetrics_tpu/audio/_deprecated.py``)."""

from torchmetrics_tpu_torch.audio import (
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from torchmetrics_tpu_torch.utilities.deprecation import root_alias

_PermutationInvariantTraining = root_alias(PermutationInvariantTraining, "audio")
_ScaleInvariantSignalDistortionRatio = root_alias(ScaleInvariantSignalDistortionRatio, "audio")
_ScaleInvariantSignalNoiseRatio = root_alias(ScaleInvariantSignalNoiseRatio, "audio")
_SignalDistortionRatio = root_alias(SignalDistortionRatio, "audio")
_SignalNoiseRatio = root_alias(SignalNoiseRatio, "audio")
