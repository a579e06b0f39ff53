"""Functional metrics of the port."""

from torchmetrics_tpu_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_auroc,
    multiclass_confusion_matrix,
    multiclass_precision_recall_curve,
    multiclass_stat_scores,
)

__all__ = [
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_confusion_matrix",
    "multiclass_precision_recall_curve",
    "multiclass_stat_scores",
]
