"""Signal-to-distortion ratios (counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``).

SDR solves for the optimal length-L distortion filter on the device: FFT auto- and
cross-correlations, a symmetric Toeplitz system built by one ``|i - j|`` gather, and a
batched ``torch.linalg.solve_ex``. The whole computation runs in float64 on every
device, as the JAX package's does in its 64-bit mode (the mode its tests run in): in
float32 the 512-tap solve moves the result by about 1e-3 dB. ``solve_ex`` leaves its
``info`` on the device and nothing reads it, so an update waits for no host read
(``torch.linalg.solve`` would check it on the host at every call).

A CUDA graph holds the solve only on the cuSOLVER backend: PyTorch's default backend
sends a batch of systems wider than 128 equations through MAGMA, whose calls end a
stream capture. Under the update engine such a step therefore falls back, under the
reason ``uncapturable:linalg_solve_ex(magma)``, and runs eagerly on the faster MAGMA
path. A caller who sets ``torch.backends.cuda.preferred_linalg_library("cusolver")``
gets a captured step; this module never sets it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from torchmetrics_tpu_torch.engine.compiled import _Ineligible, in_traced_body
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape

# the |i - j| index of each (filter length, device), built once
_TOEPLITZ_INDEX: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _toeplitz_index(length: int, device: torch.device) -> torch.Tensor:
    key = (length, device)
    index = _TOEPLITZ_INDEX.get(key)
    if index is None:
        i = torch.arange(length, device=device)
        index = _TOEPLITZ_INDEX[key] = (i[:, None] - i[None, :]).abs()
    return index


def _solve_capturable(device: torch.device) -> bool:
    """Whether a CUDA graph can hold ``torch.linalg.solve_ex`` on ``device``: always on
    the CPU (nothing is captured there), on CUDA when MAGMA is out of the build or the
    caller chose cuSOLVER."""
    if device.type != "cuda" or not torch.cuda.has_magma:
        return True
    return torch.backends.cuda.preferred_linalg_library() == torch._C._LinalgBackend.Cusolver


def _symmetric_toeplitz(vector: torch.Tensor) -> torch.Tensor:
    """Symmetric Toeplitz matrix from the first row: one ``|i - j|`` gather."""
    return vector[..., _toeplitz_index(vector.shape[-1], vector.device)]


def _compute_autocorr_crosscorr(
    target: torch.Tensor, preds: torch.Tensor, corr_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT-based autocorrelation of ``target`` and its cross-correlation with ``preds``."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(t_fft.conj() * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> torch.Tensor:
    """SDR in dB via the optimal length-``filter_length`` distortion filter.

    ``use_cg_iter`` is accepted for API parity and ignored: the dense batched solve
    handles the system directly. The result is float64 for float64 ``preds`` and
    float32 otherwise.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_distortion_ratio
        >>> target = torch.sin(torch.arange(2000.0) / 7)
        >>> preds = target + 0.1 * torch.cos(torch.arange(2000.0) / 3)
        >>> round(float(signal_distortion_ratio(preds, target, filter_length=64)), 3)
        20.055
    """
    _check_same_shape(preds, target)

    preds_dtype = preds.dtype
    preds = preds.to(torch.float64)
    target = target.to(torch.float64)

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat((r_0[..., :1] + load_diag, r_0[..., 1:]), dim=-1)

    r = _symmetric_toeplitz(r_0)
    if in_traced_body() and not _solve_capturable(r.device):
        raise _Ineligible("uncapturable:linalg_solve_ex(magma)")
    sol = torch.linalg.solve_ex(r, b[..., None])[0][..., 0]

    coh = torch.einsum("...l,...l->...", b, sol)
    ratio = coh / (1 - coh)
    val = 10.0 * torch.log10(ratio)
    return val if preds_dtype == torch.float64 else val.to(torch.float32)


def scale_invariant_signal_distortion_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """SI-SDR in dB over the trailing time axis.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (torch.sum(target**2, dim=-1, keepdim=True) + eps)
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)
