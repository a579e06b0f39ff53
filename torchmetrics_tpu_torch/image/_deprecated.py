"""Root aliases of the image metrics, which warn at construction (counterpart of
``torchmetrics_tpu/image/_deprecated.py``)."""

from torchmetrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
)
from torchmetrics_tpu_torch.utilities.deprecation import root_alias

_ErrorRelativeGlobalDimensionlessSynthesis = root_alias(ErrorRelativeGlobalDimensionlessSynthesis, "image")
_MultiScaleStructuralSimilarityIndexMeasure = root_alias(MultiScaleStructuralSimilarityIndexMeasure, "image")
_PeakSignalNoiseRatio = root_alias(PeakSignalNoiseRatio, "image")
_RelativeAverageSpectralError = root_alias(RelativeAverageSpectralError, "image")
_RootMeanSquaredErrorUsingSlidingWindow = root_alias(RootMeanSquaredErrorUsingSlidingWindow, "image")
_SpectralAngleMapper = root_alias(SpectralAngleMapper, "image")
_SpectralDistortionIndex = root_alias(SpectralDistortionIndex, "image")
_StructuralSimilarityIndexMeasure = root_alias(StructuralSimilarityIndexMeasure, "image")
_TotalVariation = root_alias(TotalVariation, "image")
_UniversalImageQualityIndex = root_alias(UniversalImageQualityIndex, "image")
