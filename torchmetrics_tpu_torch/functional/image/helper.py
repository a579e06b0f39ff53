"""Shared filters of the image metrics (counterpart of ``torchmetrics_tpu/functional/image/helper.py``).

Every separable window filter (gaussian, uniform) is a product with a dense band
matrix per axis, as in the JAX package: a k-tap VALID correlation along an axis of
length n is ``Y = M X`` with an ``(n - k + 1, n)`` matrix ``M``. The taps are built in
float64 numpy exactly as the JAX package builds them, so a band cast to float32 is
bit-equal to the JAX package's ``_band_matrix_np(...).astype(float32)``.

The bands, the reflect-pad gathers and the other index constants live in caches keyed
by shape, dtype and device, built on the device by fills and ``arange``: no update
copies anything from the host, so a CUDA graph can hold it (its guarded first step
fills the caches, the capture finds them warm). The products are ``torch.matmul``; a
float32 product is exact to float32 only at ``torch.get_float32_matmul_precision() ==
"highest"`` (PyTorch's default: no TF32), which the port does not change.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

# the device constants of the image metrics: bands, gather indices, masks
_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def _device_constant(key: tuple, make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``make()``'s tensor, made once per ``key`` (which names its shape, dtype and device)."""
    value = _CONSTANTS.get(key)
    if value is None:
        value = _CONSTANTS[key] = make()
    return value


def _gaussian_np(kernel_size: int, sigma: float) -> np.ndarray:
    """1-D gaussian taps in float64, normalized to sum 1 (the JAX package's own)."""
    dist = np.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, dtype=np.float64)
    gauss = np.exp(-((dist / sigma) ** 2) / 2)
    return gauss / gauss.sum()


def _uniform_np(kernel_size: int) -> np.ndarray:
    """1-D mean taps in float64."""
    return np.full(kernel_size, 1.0 / kernel_size)


def _band(taps: np.ndarray, n_in: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The band of ``taps`` over ``n_in`` inputs in ``dtype`` on ``device``, cached: a
    float64 zero matrix whose k diagonals are filled with the float64 taps, then cast
    once (as numpy's ``astype``)."""
    values = tuple(float(t) for t in taps)

    def make() -> torch.Tensor:
        n_out = n_in - len(values) + 1
        full = torch.zeros(max(n_out, 0), n_in, dtype=torch.float64, device=device)
        if n_out > 0:
            for i, tap in enumerate(values):
                full.diagonal(i).fill_(tap)
        return full.to(dtype)

    return _device_constant(("band", values, n_in, dtype, device), make)


def _filter_separable_2d(x: torch.Tensor, kernel_h: np.ndarray, kernel_w: np.ndarray) -> torch.Tensor:
    """VALID separable filter over NCHW: the H band from the left, then the W band from
    the right (the JAX package's contraction order)."""
    mh = _band(kernel_h, x.shape[2], x.dtype, x.device)
    mw = _band(kernel_w, x.shape[3], x.dtype, x.device)
    return torch.matmul(torch.matmul(mh, x), mw.T)


def _filter_separable_3d(x: torch.Tensor, k_d: np.ndarray, k_h: np.ndarray, k_w: np.ndarray) -> torch.Tensor:
    """VALID separable filter over NCDHW: D first, then H, then W."""
    md = _band(k_d, x.shape[2], x.dtype, x.device)
    mh = _band(k_h, x.shape[3], x.dtype, x.device)
    mw = _band(k_w, x.shape[4], x.dtype, x.device)
    n, c, d, h, w = x.shape
    y = torch.matmul(md, x.reshape(n, c, d, h * w)).reshape(n, c, -1, h, w)
    return torch.matmul(torch.matmul(mh, y), mw.T)


def _avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of NCHW as crop and the mean of a reshape (odd sizes floor)."""
    n, c, h, w = x.shape
    x = x[..., : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 average pool of NCDHW as crop and the mean of a reshape."""
    n, c, d, h, w = x.shape
    x = x[..., : d // 2 * 2, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).mean(dim=(3, 5, 7))


def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source positions of an axis of length ``n`` reflect-padded by ``pad`` on each
    side (the edge not repeated), cached. The reflection has period ``2 (n - 1)``, so a
    pad as wide as the axis or wider reflects again, as ``numpy.pad(mode="reflect")``
    does, where ``F.pad(mode="reflect")`` raises."""

    def make() -> torch.Tensor:
        pos = torch.arange(-pad, n + pad, device=device)
        if n == 1:
            return torch.zeros_like(pos)
        period = 2 * (n - 1)
        r = torch.remainder(pos, period)
        return torch.where(r >= n, period - r, r)

    return _device_constant(("reflect", n, pad, device), make)


def _reflect_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Reflect-pad the trailing ``len(pads)`` axes of ``x``, axis i by ``pads[i]`` on each side."""
    first = x.ndim - len(pads)
    for i, pad in enumerate(pads):
        if pad:
            dim = first + i
            x = x.index_select(dim, _reflect_index(x.shape[dim], pad, x.device))
    return x


def _reflect_pad_2d(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflection pad of H and W of an NCHW tensor."""
    return _reflect_pad(x, (pad_h, pad_w))


def _single_dimension_pad(x: torch.Tensor, dim: int, pad: int, outer_pad: int = 0) -> torch.Tensor:
    """Scipy-style asymmetric reflection over one axis: ``pad`` mirrored rows on the
    left, ``pad + outer_pad - 1`` on the right (``uniform_filter``'s layout for even
    windows)."""
    n = x.shape[dim]
    left = x.narrow(dim, 0, pad).flip(dim)
    start = n - pad - outer_pad + 1
    right = x.narrow(dim, start, n - start).flip(dim)
    return torch.cat([left, x, right], dim=dim)


def _uniform_filter(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """Scipy-compatible ``window_size`` mean filter over NCHW, as two band products."""
    for dim in (2, 3):
        x = _single_dimension_pad(x, dim, window_size // 2, outer_pad=window_size % 2)
    k1d = _uniform_np(window_size)
    return _filter_separable_2d(x, k1d, k1d)


def _check_image_shape(preds: torch.Tensor, target: torch.Tensor, ndim: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BxCxHxW checks of the pixel metrics."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )
    if preds.ndim != ndim:
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target
