"""SSIM and multi-scale SSIM (counterpart of ``torchmetrics_tpu/functional/image/ssim.py``).

The five moment maps (mean of preds, of target, of their squares and of their
product) come from one separable band filter over a ``(5B, C, ...)`` stack. Pins kept
from the JAX package:

- the window is reflect-padded and cropped by the *gaussian* size, which comes from
  ``sigma``, also when ``gaussian_kernel=False`` filters with ``kernel_size``;
- in 3-D, axis i is padded and cropped by ``(gaussian_size[i] - 1) // 2``;
- a pad of 0 crops ``[0:-0]``, an empty map whose mean is NaN;
- MS-SSIM takes ``data_range=None`` again from the pooled images at each scale.

``data_range=None`` stays a tensor on the images' device (nothing is read back), so
the update runs in a captured graph under the engine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.helper import (
    _avg_pool2d,
    _avg_pool3d,
    _filter_separable_2d,
    _filter_separable_3d,
    _gaussian_np,
    _reflect_pad,
    _uniform_np,
)
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.distributed import reduce


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cast ``target`` to the dtype of ``preds``; same shapes, BxCxHxW or BxCxDxHxW."""
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target


def _crop(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``x[..., p0:-p0, p1:-p1(, p2:-p2)]``, empty where a pad is 0."""
    if len(pads) == 3:
        return x[..., pads[0] : -pads[0], pads[1] : -pads[1], pads[2] : -pads[2]]
    return x[..., pads[0] : -pads[0], pads[1] : -pads[1]]


def _ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-image SSIM ``(B,)`` (and the full map or the contrast sensitivity)."""
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2 or len(sigma) not in (2, 3):
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less that target dimensionality,"
            f" which is: {preds.ndim}"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range = torch.maximum(preds.amax() - preds.amin(), target.amax() - target.amin())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds = preds.to(dtype)
    target = target.to(dtype)
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    pads = [(g - 1) // 2 for g in gauss_kernel_size]

    preds = _reflect_pad(preds, pads)
    target = _reflect_pad(target, pads)

    # both windows are separable: the gaussian an outer product, the uniform (1/k)⊗(1/k)
    if gaussian_kernel:
        k1d = [_gaussian_np(gauss_kernel_size[i], sigma[i]) for i in range(len(sigma))]
    else:
        k1d = [_uniform_np(k) for k in kernel_size]

    input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])  # (5B, C, ...)
    outputs = _filter_separable_3d(input_list, *k1d) if is_3d else _filter_separable_2d(input_list, *k1d)
    b = preds.shape[0]
    mu_pred, mu_target, e_pp, e_tt, e_pt = outputs.split(b)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = e_pp - mu_pred_sq
    sigma_target_sq = e_tt - mu_target_sq
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx_full_image = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)
    ssim_idx = _crop(ssim_idx_full_image, pads)

    if return_contrast_sensitivity:
        contrast_sensitivity = _crop(upper / lower, pads)
        return ssim_idx.reshape(b, -1).mean(-1), contrast_sensitivity.reshape(b, -1).mean(-1)

    if return_full_image:
        return ssim_idx.reshape(b, -1).mean(-1), ssim_idx_full_image

    return ssim_idx.reshape(b, -1).mean(-1)


def _ssim_compute(similarities: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Reduce per-image similarities."""
    return reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Structural similarity index measure (SSIM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import structural_similarity_index_measure
        >>> img = torch.ones(1, 3, 16, 16) * 0.5
        >>> round(float(structural_similarity_index_measure(img, img, data_range=1.0)), 4)
        1.0
    """
    preds, target = _ssim_check_inputs(preds, target)
    similarity_pack = _ssim_update(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        data_range,
        k1,
        k2,
        return_full_image,
        return_contrast_sensitivity,
    )
    if isinstance(similarity_pack, tuple):
        similarity, image = similarity_pack
        return _ssim_compute(similarity, reduction), image
    return _ssim_compute(similarity_pack, reduction)


def _get_normalized_sim_and_cs(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    normalize: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    sim, contrast_sensitivity = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """Per-image MS-SSIM over ``len(betas)`` scales."""
    mcs_list: List[torch.Tensor] = []

    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    pool = _avg_pool2d if len(kernel_size) == 2 else _avg_pool3d
    sim = None
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=normalize
        )
        mcs_list.append(contrast_sensitivity)
        preds = pool(preds)
        target = pool(target)

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)

    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2

    # each scale to its own power: python floats, so no constant enters from the host
    mcs_weighted = torch.stack([mcs_stack[i] ** beta for i, beta in enumerate(betas)])
    return torch.prod(mcs_weighted, dim=0)


def _multiscale_ssim_compute(similarities: torch.Tensor, reduction: Optional[str] = "elementwise_mean") -> torch.Tensor:
    """Reduce per-image MS-SSIM values."""
    return reduce(similarities, reduction)


def multiscale_structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> torch.Tensor:
    """Multi-scale SSIM.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> img = torch.ones(1, 1, 64, 64) * 0.5
        >>> round(float(multiscale_structural_similarity_index_measure(img, img, data_range=1.0, betas=(0.5, 0.5))), 4)
        1.0
    """
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    similarities = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return _multiscale_ssim_compute(similarities, reduction)
