"""Inception Score (counterpart of ``torchmetrics_tpu/image/inception.py``).

A ``cat``-style list of logits (``dist_reduce_fx=None``: a raw gather at sync), so the
update falls back under the engine (``list-state``); the split KL runs at ``compute``
after a host permutation by numpy's global ``np.random.permutation``, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.image._extractor import ExtractorFollowsDevice, resolve_feature_extractor
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.compute import _safe_xlogy
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


class InceptionScore(ExtractorFollowsDevice, Metric):
    """IS = exp(E[KL(p(y|x) ‖ p(y))]), mean and std over ``splits``.

    Example:
        >>> import numpy as np, torch
        >>> from torchmetrics_tpu_torch.image import InceptionScore
        >>> proj = torch.randn(3 * 8 * 8, 10, generator=torch.Generator().manual_seed(0))
        >>> inception = InceptionScore(lambda x: x.float().flatten(1) @ proj / 255, num_features=10, splits=2, device="cpu")
        >>> gen = torch.Generator().manual_seed(1)
        >>> inception.update(torch.randint(0, 255, (20, 3, 8, 8), dtype=torch.uint8, generator=gen))
        >>> np.random.seed(0)
        >>> mean, std = inception.compute()
        >>> float(mean) > 1
        True
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    features: List[torch.Tensor]

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        num_features: Optional[int] = None,
        allow_random_features: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `InceptionScore` will save all extracted features in buffer."
            " For large datasets this may lead to large memory footprint.",
            UserWarning,
        )
        self.inception, _ = resolve_feature_extractor(
            feature, num_features, allow_random_features=allow_random_features, device=self.device
        )
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Integer input to argument `splits` must be positive")
        self.splits = splits
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: torch.Tensor) -> None:
        """Extract and buffer logits."""
        imgs = (imgs * 255).to(torch.uint8) if self.normalize else imgs
        self.features.append(self.inception(imgs))

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and (sample) std of each split's exp(KL)."""
        features = dim_zero_cat(self.features)
        idx = np.random.permutation(features.shape[0])
        features = features[torch.from_numpy(idx).to(features.device)]

        prob = features.softmax(dim=1)
        log_prob = features.log_softmax(dim=1)
        kl_ = []
        for p, log_p in zip(prob.tensor_split(self.splits, dim=0), log_prob.tensor_split(self.splits, dim=0)):
            mean_prob = p.mean(dim=0, keepdim=True)
            # the marginal term through xlogy: a class whose probability underflows to 0
            # contributes 0, not 0 * log(0)
            kl = p * log_p - _safe_xlogy(p, mean_prob.expand_as(p))
            kl_.append(kl.sum(dim=1).mean().exp())
        kl_stack = torch.stack(kl_)
        return kl_stack.mean(), kl_stack.std(correction=1)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        val = val if val is not None else self.compute()[0]
        return self._plot(val, ax)
