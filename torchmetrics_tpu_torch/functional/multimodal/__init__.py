"""Functional multimodal metrics (counterpart of ``torchmetrics_tpu/functional/multimodal/__init__.py``)."""

from torchmetrics_tpu_torch.functional.multimodal.clip_score import clip_score

__all__ = ["clip_score"]
