"""Multimodal metrics (counterpart of ``torchmetrics_tpu/multimodal/__init__.py``)."""

from torchmetrics_tpu_torch.multimodal.clip_score import CLIPScore

__all__ = ["CLIPScore"]
