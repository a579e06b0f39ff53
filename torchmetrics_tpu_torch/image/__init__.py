"""Modular image metrics (counterpart of ``torchmetrics_tpu/image/__init__.py``)."""

from torchmetrics_tpu_torch.image.d_lambda import SpectralDistortionIndex
from torchmetrics_tpu_torch.image.ergas import ErrorRelativeGlobalDimensionlessSynthesis
from torchmetrics_tpu_torch.image.fid import FrechetInceptionDistance
from torchmetrics_tpu_torch.image.inception import InceptionScore
from torchmetrics_tpu_torch.image.kid import KernelInceptionDistance
from torchmetrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from torchmetrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from torchmetrics_tpu_torch.image.psnrb import PeakSignalNoiseRatioWithBlockedEffect
from torchmetrics_tpu_torch.image.rase import RelativeAverageSpectralError
from torchmetrics_tpu_torch.image.rmse_sw import RootMeanSquaredErrorUsingSlidingWindow
from torchmetrics_tpu_torch.image.sam import SpectralAngleMapper
from torchmetrics_tpu_torch.image.ssim import (
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)
from torchmetrics_tpu_torch.image.tv import TotalVariation
from torchmetrics_tpu_torch.image.uqi import UniversalImageQualityIndex

__all__ = [
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
]
