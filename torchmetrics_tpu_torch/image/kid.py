"""Kernel Inception Distance (counterpart of ``torchmetrics_tpu/image/kid.py``).

Raw feature lists (``dist_reduce_fx=None``), so the update falls back under the engine
(``list-state``), as in the JAX package; the polynomial-kernel MMD over random subsets
runs at ``compute``. The subsets are drawn on the host by numpy's global
``np.random.permutation``, as the JAX package draws them, so one ``np.random.seed`` gives
both packages the same subsets; the indices reach the device in one copy and every
subset's MMD comes out of one batched product.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image._extractor import ExtractorFollowsDevice, resolve_feature_extractor
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def poly_kernel(
    f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """Polynomial kernel matrix of the rows of ``f1`` against those of ``f2`` (over any
    leading batch dims)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    return (f1 @ f2.transpose(-1, -2) * gamma + coef) ** degree


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD estimate from kernel matrices (over any leading batch dims)."""
    m = k_xx.shape[-1]
    kt_xx_sum = (k_xx.sum(dim=-1) - k_xx.diagonal(dim1=-2, dim2=-1)).sum(dim=-1)
    kt_yy_sum = (k_yy.sum(dim=-1) - k_yy.diagonal(dim1=-2, dim2=-1)).sum(dim=-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_mmd(
    f_real: torch.Tensor, f_fake: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """MMD under the polynomial kernel (over any leading batch dims)."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(ExtractorFollowsDevice, Metric):
    """KID: the MMD² of the feature distributions, mean and std over random subsets.

    Example:
        >>> import numpy as np, torch
        >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
        >>> proj = torch.randn(3 * 8 * 8, 16, generator=torch.Generator().manual_seed(0))
        >>> extract = lambda x: x.float().flatten(1) @ proj / 255
        >>> kid = KernelInceptionDistance(extract, num_features=16, subsets=5, subset_size=20, device="cpu")
        >>> gen = torch.Generator().manual_seed(1)
        >>> kid.update(torch.randint(0, 200, (30, 3, 8, 8), dtype=torch.uint8, generator=gen), real=True)
        >>> kid.update(torch.randint(50, 255, (30, 3, 8, 8), dtype=torch.uint8, generator=gen), real=False)
        >>> np.random.seed(0)
        >>> mean, std = kid.compute()
        >>> float(mean) > 0
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    real_features: List[torch.Tensor]
    fake_features: List[torch.Tensor]

    def __init__(
        self,
        feature: Union[str, int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        allow_random_features: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `KernelInceptionDistance` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self.inception, _ = resolve_feature_extractor(
            feature, num_features, allow_random_features=allow_random_features, device=self.device
        )
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def update(self, imgs: torch.Tensor, real: Union[bool, torch.Tensor]) -> None:
        """Extract and buffer features on the side ``real`` names."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        features = self.inception(imgs)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and std of the subset MMDs: host-drawn subsets, one batched product."""
        real_features = dim_zero_cat(self.real_features)
        fake_features = dim_zero_cat(self.fake_features)

        n_samples_real = real_features.shape[0]
        if n_samples_real < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        n_samples_fake = fake_features.shape[0]
        if n_samples_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")

        real_idx = np.stack([np.random.permutation(n_samples_real)[: self.subset_size] for _ in range(self.subsets)])
        fake_idx = np.stack([np.random.permutation(n_samples_fake)[: self.subset_size] for _ in range(self.subsets)])
        idx = torch.from_numpy(np.stack([real_idx, fake_idx])).to(real_features.device)
        kid_scores = poly_mmd(real_features[idx[0]], fake_features[idx[1]], self.degree, self.gamma, self.coef)
        return kid_scores.mean(), kid_scores.std(correction=0)

    def reset(self) -> None:
        """Reset, keeping the real features unless ``reset_real_features``."""
        if self.reset_real_features:
            super().reset()
            return
        value = self.real_features
        super().reset()
        self.real_features = value

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        val = val if val is not None else self.compute()[0]
        return self._plot(val, ax)
