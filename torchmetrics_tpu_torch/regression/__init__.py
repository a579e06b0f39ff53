"""Modular regression metrics of the port: the sum-state half of the JAX package's
``regression``."""

from torchmetrics_tpu_torch.regression.explained_variance import ExplainedVariance
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
from torchmetrics_tpu_torch.regression.r2 import R2Score
from torchmetrics_tpu_torch.regression.rse import RelativeSquaredError
from torchmetrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore

__all__ = [
    "ExplainedVariance",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "R2Score",
    "RelativeSquaredError",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
