"""Modular SSIM and MS-SSIM (counterpart of ``torchmetrics_tpu/image/ssim.py``).

The state layout depends on ``reduction``: float ``similarity`` and ``total`` sums for
``elementwise_mean`` and ``sum`` (the update runs in a captured graph under the
engine), a ``cat`` list of per-image values for ``none`` (it falls back, as a list
state does in the JAX package); ``return_full_image`` and
``return_contrast_sensitivity`` add an ``image_return`` list.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.ssim import (
    _multiscale_ssim_update,
    _ssim_check_inputs,
    _ssim_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


def _similarity_states(metric: Metric, reduction: Optional[str]) -> None:
    if reduction not in _REDUCTIONS:
        raise ValueError(f"Argument `reduction` must be one of {_REDUCTIONS}, but got {reduction}")
    if reduction in ("elementwise_mean", "sum"):
        metric.add_state("similarity", 0.0, dist_reduce_fx="sum")
    else:
        metric.add_state("similarity", [], dist_reduce_fx="cat")
    metric.add_state("total", 0.0, dist_reduce_fx="sum")


class StructuralSimilarityIndexMeasure(Metric):
    """Structural similarity index measure (SSIM).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> preds = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> metric = StructuralSimilarityIndexMeasure(device="cpu")
        >>> metric.update(preds, preds * 0.75 + 0.1)
        >>> round(float(metric.compute()), 2)
        0.96
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _similarity_states(self, reduction)
        if return_contrast_sensitivity or return_full_image:
            self.add_state("image_return", [], dist_reduce_fx="cat")

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the per-image similarities of one batch."""
        preds, target = _ssim_check_inputs(preds, target)
        similarity_pack = _ssim_update(
            preds,
            target,
            self.gaussian_kernel,
            self.sigma,
            self.kernel_size,
            self.data_range,
            self.k1,
            self.k2,
            self.return_full_image,
            self.return_contrast_sensitivity,
        )
        if isinstance(similarity_pack, tuple):
            similarity, image = similarity_pack
            self.image_return.append(image)
        else:
            similarity = similarity_pack

        if self.reduction in ("elementwise_mean", "sum"):
            self.similarity = self.similarity + similarity.sum()
            self.total = self.total + preds.shape[0]
        else:
            self.similarity.append(similarity)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The mean, the sum or every per-image SSIM (and the returned maps)."""
        if self.reduction == "elementwise_mean":
            similarity = self.similarity / self.total
        elif self.reduction == "sum":
            similarity = self.similarity
        else:
            similarity = dim_zero_cat(self.similarity)

        if self.return_contrast_sensitivity or self.return_full_image:
            return similarity, dim_zero_cat(self.image_return)
        return similarity

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Multi-scale SSIM.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MultiScaleStructuralSimilarityIndexMeasure
        >>> img = torch.ones(1, 1, 64, 64) * 0.5
        >>> metric = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=(0.5, 0.5), device="cpu")
        >>> metric.update(img, img)
        >>> round(float(metric.compute()), 4)
        1.0
    """

    is_differentiable: bool = True
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _similarity_states(self, reduction)

        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError(
                f"Argument `kernel_size` expected to be an sequence or an int, or a single int. Got {kernel_size}"
            )
        if isinstance(kernel_size, Sequence) and (
            len(kernel_size) not in (2, 3) or not all(isinstance(ks, int) for ks in kernel_size)
        ):
            raise ValueError(
                "Argument `kernel_size` expected to be an sequence of size 2 or 3 where each element is an int,"
                f" or a single int. Got {kernel_size}"
            )

        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        self.betas = betas
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.normalize = normalize

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Add the per-image MS-SSIM values of one batch."""
        preds, target = _ssim_check_inputs(preds, target)
        similarity = _multiscale_ssim_update(
            preds,
            target,
            self.gaussian_kernel,
            self.sigma,
            self.kernel_size,
            self.data_range,
            self.k1,
            self.k2,
            self.betas,
            self.normalize,
        )
        if self.reduction in ("elementwise_mean", "sum"):
            self.similarity = self.similarity + similarity.sum()
            self.total = self.total + preds.shape[0]
        else:
            self.similarity.append(similarity)

    def compute(self) -> torch.Tensor:
        """The mean, the sum or every per-image MS-SSIM."""
        if self.reduction == "elementwise_mean":
            return self.similarity / self.total
        if self.reduction == "sum":
            return self.similarity
        return dim_zero_cat(self.similarity)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
