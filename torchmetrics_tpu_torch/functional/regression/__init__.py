"""Functional regression metrics of the port: the sum-state half of the JAX package's
``functional/regression``."""

from torchmetrics_tpu_torch.functional.regression.explained_variance import explained_variance
from torchmetrics_tpu_torch.functional.regression.log_cosh import log_cosh_error
from torchmetrics_tpu_torch.functional.regression.log_mse import mean_squared_log_error
from torchmetrics_tpu_torch.functional.regression.mae import mean_absolute_error
from torchmetrics_tpu_torch.functional.regression.mape import mean_absolute_percentage_error
from torchmetrics_tpu_torch.functional.regression.minkowski import minkowski_distance
from torchmetrics_tpu_torch.functional.regression.mse import mean_squared_error
from torchmetrics_tpu_torch.functional.regression.r2 import r2_score
from torchmetrics_tpu_torch.functional.regression.rse import relative_squared_error
from torchmetrics_tpu_torch.functional.regression.symmetric_mape import symmetric_mean_absolute_percentage_error
from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import tweedie_deviance_score
from torchmetrics_tpu_torch.functional.regression.wmape import weighted_mean_absolute_percentage_error

__all__ = [
    "explained_variance",
    "log_cosh_error",
    "mean_absolute_error",
    "mean_absolute_percentage_error",
    "mean_squared_error",
    "mean_squared_log_error",
    "minkowski_distance",
    "r2_score",
    "relative_squared_error",
    "symmetric_mean_absolute_percentage_error",
    "tweedie_deviance_score",
    "weighted_mean_absolute_percentage_error",
]
