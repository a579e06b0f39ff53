"""Modular LPIPS (counterpart of ``torchmetrics_tpu/image/lpip.py``).

Sum-of-distances and count states. The update's range check reads the host, so under
the engine it falls back, as the JAX engine's does; an input that records a gradient
takes the eager path too (``grad-input``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.image.lpips import _lpips_compute, _lpips_update, lpips_network
from torchmetrics_tpu_torch.image._extractor import ExtractorFollowsDevice
from torchmetrics_tpu_torch.metric import Metric


class LearnedPerceptualImagePatchSimilarity(ExtractorFollowsDevice, Metric):
    """LPIPS.

    Args:
        net_type: ``'alex'`` / ``'vgg'`` / ``'squeeze'`` (bundled learned heads and the
            backbone, random unless weights are supplied below), or a
            ``net(img1, img2, normalize=...) -> (N,)`` callable built with
            :func:`torchmetrics_tpu_torch.functional.image.lpips.make_lpips_net`.
        reduction: ``'mean'`` or ``'sum'`` over the accumulated per-pair distances.
        normalize: True if inputs are in [0, 1] (scaled to [-1, 1] inside).
        backbone_state_dict: a torchvision checkpoint for the string backbone.
        backbone_variables: the JAX package's flax variables for it.
        allow_random_backbone: opt in to the seeded random backbone.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> lpips = LearnedPerceptualImagePatchSimilarity("squeeze", allow_random_backbone=True, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> img1, img2 = torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1, torch.rand(2, 3, 32, 32, generator=gen) * 2 - 1
        >>> float(lpips(img1, img2)) > 0
        True
    """

    is_differentiable: bool = True
    higher_is_better: bool = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _follows_device = "net"

    def __init__(
        self,
        net_type: Union[str, Callable[..., torch.Tensor]] = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        backbone_state_dict: Optional[Any] = None,
        backbone_variables: Optional[Any] = None,
        allow_random_backbone: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(net_type, str):
            valid_net_type = ("vgg", "alex", "squeeze")
            if net_type not in valid_net_type:
                raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
            self.net = lpips_network(
                net_type,
                backbone_state_dict=backbone_state_dict,
                backbone_variables=backbone_variables,
                allow_random_backbone=allow_random_backbone,
                device=self.device,
            )
        elif callable(net_type):
            self.net = net_type
        else:
            raise ValueError("Argument `net_type` must be a string or a callable net.")

        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction

        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be an bool but got {normalize}")
        self.normalize = normalize

        self.add_state("sum_scores", 0.0, dist_reduce_fx="sum")
        self.add_state("total", 0.0, dist_reduce_fx="sum")

    def update(self, img1: torch.Tensor, img2: torch.Tensor) -> None:
        """Accumulate the batch's LPIPS distances."""
        loss, total = _lpips_update(img1, img2, net=self.net, normalize=self.normalize)
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        """The reduced LPIPS."""
        return _lpips_compute(self.sum_scores, self.total, self.reduction)

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
