"""Functional image metrics (counterpart of ``torchmetrics_tpu/functional/image/__init__.py``)."""

from torchmetrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from torchmetrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis
from torchmetrics_tpu_torch.functional.image.gradients import image_gradients
from torchmetrics_tpu_torch.functional.image.lpips import learned_perceptual_image_patch_similarity, make_lpips_net
from torchmetrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from torchmetrics_tpu_torch.functional.image.psnrb import peak_signal_noise_ratio_with_blocked_effect
from torchmetrics_tpu_torch.functional.image.rase import relative_average_spectral_error
from torchmetrics_tpu_torch.functional.image.rmse_sw import root_mean_squared_error_using_sliding_window
from torchmetrics_tpu_torch.functional.image.sam import spectral_angle_mapper
from torchmetrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.tv import total_variation
from torchmetrics_tpu_torch.functional.image.uqi import universal_image_quality_index

__all__ = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "learned_perceptual_image_patch_similarity",
    "make_lpips_net",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "peak_signal_noise_ratio_with_blocked_effect",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
]
