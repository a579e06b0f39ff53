"""Signal-to-noise ratios (counterpart of ``torchmetrics_tpu/functional/audio/snr.py``)."""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape


def signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """SNR in dB over the trailing time axis.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        16.1805
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SI-SNR: SI-SDR of zero-mean inputs."""
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """C-SI-SNR over complex spectra, or real ones with a trailing (real, imaginary) axis
    of 2: each sample's ``(frequency, time, 2)`` block is one real signal."""
    if preds.is_complex():
        preds = torch.view_as_real(preds)
    if target.is_complex():
        target = torch.view_as_real(target)
    if preds.ndim < 3 or preds.shape[-1] != 2 or target.ndim < 3 or target.shape[-1] != 2:
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            " but got {} and {}.".format(tuple(preds.shape), tuple(target.shape))
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
