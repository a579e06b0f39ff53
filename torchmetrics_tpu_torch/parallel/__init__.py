"""Cross-process synchronization of metric states."""

from torchmetrics_tpu_torch.parallel.sync import distributed_available, gather_all_tensors

__all__ = ["distributed_available", "gather_all_tensors"]
