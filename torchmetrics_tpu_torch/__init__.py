"""PyTorch/CUDA port of torchmetrics_tpu.

The JAX package ``torchmetrics_tpu`` is the reference; this package gives the same
metrics on PyTorch, with the JAX package's Pallas kernels rewritten by hand in CUDA
C++ for Hopper (``csrc/``). It imports neither JAX nor the JAX package.

Metrics run on the GPU unless built with ``device="cpu"``.
"""

from torchmetrics_tpu_torch.classification import (
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassConfusionMatrix,
    MulticlassPrecisionRecallCurve,
    MulticlassStatScores,
)
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric

__all__ = [
    "Metric",
    "MetricCollection",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
]
