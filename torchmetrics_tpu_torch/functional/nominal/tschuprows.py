"""Tschuprow's T (counterpart of ``torchmetrics_tpu/functional/nominal/tschuprows.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _host_table,
    _nominal_bins_update,
    _nominal_dense_update,
    _nominal_input_validation,
    _nominal_result,
    _pairwise_matrix,
    _unable_to_use_bias_correction_warning,
)


def _tschuprows_t_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    """One batch's ``(C, C)`` int32 table."""
    return _nominal_bins_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _tschuprows_t_statistic(cm: np.ndarray, bias_correction: bool) -> float:
    """T = sqrt(phi^2 / sqrt((r - 1)(c - 1))), optionally bias-corrected, over a host
    table without empty rows or columns; float64, clipped to [0, 1]."""
    cm_sum = cm.sum()
    phi_squared = _compute_chi_squared(cm, bias_correction) / cm_sum
    n_rows, n_cols = cm.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, n_rows, n_cols, cm_sum
        )
        if min(rows_corrected, cols_corrected) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Tschuprow's T")
            return float("nan")
        value = np.sqrt(phi_squared_corrected / np.sqrt((rows_corrected - 1) * (cols_corrected - 1)))
    else:
        value = np.sqrt(phi_squared / np.sqrt((n_rows - 1) * (n_cols - 1)))
    return float(np.clip(value, 0.0, 1.0))


def _tschuprows_t_compute(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    """Tschuprow's T over the accumulated table: one host read, float32 on its device."""
    return _nominal_result(_tschuprows_t_statistic(_host_table(confmat), bias_correction), confmat.device)


def tschuprows_t(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Tschuprow's T association between two categorical series; the category values
    may be arbitrary.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tschuprows_t
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 0, 0])
        >>> round(float(tschuprows_t(preds, target)), 4)
        0.4677
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_dense_update(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def tschuprows_t_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Tschuprow's T between every pair of the columns of ``matrix`` ``(N, num_variables)``."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda cm: _tschuprows_t_statistic(cm, bias_correction), nan_strategy, nan_replace_value
    )
