"""Cramér's V (counterpart of ``torchmetrics_tpu/functional/nominal/cramers.py``)."""

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


def _cramers_v_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    """One batch's ``(C, C)`` int32 table."""
    return _nominal_bins_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _cramers_v_statistic(cm: np.ndarray, bias_correction: bool) -> float:
    """V = sqrt(phi^2 / min(r - 1, c - 1)), optionally bias-corrected, over a host table
    without empty rows or columns; float64, clipped to [0, 1]."""
    cm_sum = cm.sum()
    phi_squared = _compute_chi_squared(cm, bias_correction) / cm_sum
    n_rows, n_cols = cm.shape
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, n_rows, n_cols, cm_sum
        )
        if min(rows_corrected, cols_corrected) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
            return float("nan")
        value = np.sqrt(phi_squared_corrected / min(rows_corrected - 1, cols_corrected - 1))
    else:
        value = np.sqrt(phi_squared / min(n_rows - 1, n_cols - 1))
    return float(np.clip(value, 0.0, 1.0))


def _cramers_v_compute(confmat: torch.Tensor, bias_correction: bool) -> torch.Tensor:
    """Cramér's V over the accumulated table: one host read, float32 on its device."""
    return _nominal_result(_cramers_v_statistic(_host_table(confmat), bias_correction), confmat.device)


def cramers_v(
    preds: torch.Tensor,
    target: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Cramér's V association between two categorical series; the category values
    may be arbitrary (floats, non-contiguous integers).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 0, 0])
        >>> round(float(cramers_v(preds, target)), 4)
        0.4677
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_dense_update(preds, target, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def cramers_v_matrix(
    matrix: torch.Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Cramér's V between every pair of the columns of ``matrix`` ``(N, num_variables)``."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda cm: _cramers_v_statistic(cm, bias_correction), nan_strategy, nan_replace_value
    )
