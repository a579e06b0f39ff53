"""Modular CLIPScore (counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``).

A float ``score`` sum and an int32 ``n_samples`` count. The towers run on the metric's
device (``functional/multimodal/clip_score.py``); an update takes captions, so the
update engine leaves it to the eager path (``non-tensor-input``). ``model`` and
``processor`` are read from the loader's cache, never held by the metric: a clone, a
pickle or a ``cuda()`` of the metric neither copies nor moves the towers other metrics
share.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.multimodal.clip_score import (
    _DEFAULT_MODEL,
    EmbedFn,
    Images,
    _clip_score_update,
    _get_model_and_processor,
)
from torchmetrics_tpu_torch.metric import Metric


class CLIPScore(Metric):
    """Streaming text-image similarity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import CLIPScore
        >>> embed = lambda images, text: (torch.ones(len(images), 4), torch.tensor([[1.0, 1.0, 1.0, -1.0]] * len(text)))
        >>> metric = CLIPScore(embed_fn=embed, device="cpu")
        >>> metric.update(torch.zeros(2, 3, 8, 8), ["a photo", "a cat"])
        >>> float(metric.compute())
        50.0
    """

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    score: torch.Tensor
    n_samples: torch.Tensor

    def __init__(
        self,
        model_name_or_path: str = _DEFAULT_MODEL,
        embed_fn: Optional[EmbedFn] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.embed_fn = embed_fn
        if embed_fn is None:
            _get_model_and_processor(model_name_or_path)  # loads now: an uncached checkpoint raises here
        self.add_state("score", 0.0, dist_reduce_fx="sum")
        self.add_state("n_samples", 0, dist_reduce_fx="sum")

    @property
    def model(self) -> Any:
        """The CLIP towers (on the CPU; the update runs a copy on the metric's device), or
        None with ``embed_fn``."""
        return None if self.embed_fn is not None else _get_model_and_processor(self.model_name_or_path)[0]

    @property
    def processor(self) -> Any:
        """The CLIP processor, or None with ``embed_fn``."""
        return None if self.embed_fn is not None else _get_model_and_processor(self.model_name_or_path)[1]

    def update(self, images: Images, text: Union[str, List[str]]) -> None:
        """Fold one batch of image / caption pairs into the running score."""
        score, n_samples = _clip_score_update(images, text, self.model, self.processor, self.embed_fn, self.device)
        self.score = self.score + score.sum(0)
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> torch.Tensor:
        """Average CLIPScore, clamped at zero."""
        return torch.maximum(self.score / self.n_samples, torch.zeros_like(self.score))

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)
