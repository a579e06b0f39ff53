"""Functional classification metrics of the port."""

from torchmetrics_tpu_torch.functional.classification.accuracy import multiclass_accuracy
from torchmetrics_tpu_torch.functional.classification.auroc import multiclass_auroc
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import multiclass_confusion_matrix
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    multiclass_precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_confusion_matrix",
    "multiclass_precision_recall_curve",
    "multiclass_stat_scores",
]
