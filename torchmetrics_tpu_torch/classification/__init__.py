"""Modular classification metrics of the port."""

from torchmetrics_tpu_torch.classification.accuracy import MulticlassAccuracy
from torchmetrics_tpu_torch.classification.auroc import MulticlassAUROC
from torchmetrics_tpu_torch.classification.confusion_matrix import MulticlassConfusionMatrix
from torchmetrics_tpu_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassConfusionMatrix",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
]
