"""Pearson's contingency coefficient (counterpart of ``torchmetrics_tpu/functional/nominal/pearson.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _compute_chi_squared,
    _host_table,
    _nominal_bins_update,
    _nominal_dense_update,
    _nominal_input_validation,
    _nominal_result,
    _pairwise_matrix,
)


def _pearsons_contingency_coefficient_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    """One batch's ``(C, C)`` int32 table."""
    return _nominal_bins_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_statistic(cm: np.ndarray) -> float:
    """sqrt(phi^2 / (1 + phi^2)) over a host table without empty rows or columns."""
    phi_squared = _compute_chi_squared(cm, bias_correction=False) / cm.sum()
    return float(np.clip(np.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0))


def _pearsons_contingency_coefficient_compute(confmat: torch.Tensor) -> torch.Tensor:
    """The coefficient over the accumulated table: one host read, float32 on its device."""
    return _nominal_result(_pearsons_contingency_coefficient_statistic(_host_table(confmat)), confmat.device)


def pearsons_contingency_coefficient(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Pearson's contingency coefficient between two categorical series; the category
    values may be arbitrary.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 0, 0])
        >>> round(float(pearsons_contingency_coefficient(preds, target)), 4)
        0.6631
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_dense_update(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def pearsons_contingency_coefficient_matrix(
    matrix: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""The contingency coefficient between every pair of the columns of ``matrix``."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, _pearsons_contingency_coefficient_statistic, nan_strategy, nan_replace_value)
