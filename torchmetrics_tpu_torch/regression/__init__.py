"""Modular regression metrics of the port (counterpart of ``torchmetrics_tpu/regression``)."""

from torchmetrics_tpu_torch.regression.concordance import ConcordanceCorrCoef
from torchmetrics_tpu_torch.regression.cosine_similarity import CosineSimilarity
from torchmetrics_tpu_torch.regression.explained_variance import ExplainedVariance
from torchmetrics_tpu_torch.regression.kendall import KendallRankCorrCoef
from torchmetrics_tpu_torch.regression.kl_divergence import KLDivergence
from torchmetrics_tpu_torch.regression.log_cosh import LogCoshError
from torchmetrics_tpu_torch.regression.log_mse import MeanSquaredLogError
from torchmetrics_tpu_torch.regression.mae import MeanAbsoluteError
from torchmetrics_tpu_torch.regression.mape import (
    MeanAbsolutePercentageError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.regression.minkowski import MinkowskiDistance
from torchmetrics_tpu_torch.regression.mse import MeanSquaredError
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef
from torchmetrics_tpu_torch.regression.r2 import R2Score
from torchmetrics_tpu_torch.regression.rse import RelativeSquaredError
from torchmetrics_tpu_torch.regression.spearman import SpearmanCorrCoef
from torchmetrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanSquaredLogError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
