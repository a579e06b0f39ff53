"""Theil's U, the uncertainty coefficient (counterpart of ``torchmetrics_tpu/functional/nominal/theils_u.py``)."""

from __future__ import annotations

import itertools
from typing import Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _host_table,
    _nominal_bins_update,
    _nominal_dense_update,
    _nominal_input_validation,
    _nominal_result,
)


def _conditional_entropy_compute(confmat: np.ndarray) -> float:
    """H(X|Y) from a host table without empty rows or columns."""
    total = confmat.sum()
    p_xy = confmat / total
    p_y = confmat.sum(1) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = p_xy * np.log(p_y[:, None] / p_xy)
    return float(np.nansum(terms))


def _theils_u_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    """One batch's ``(C, C)`` int32 table."""
    return _nominal_bins_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _theils_u_statistic(cm: np.ndarray) -> float:
    """U = (H(X) - H(X|Y)) / H(X) over a host table without empty rows or columns; 0
    when H(X) is 0."""
    s_xy = _conditional_entropy_compute(cm)
    p_x = cm.sum(0) / cm.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        s_x = -float(np.nansum(p_x * np.log(p_x)))
    if s_x == 0:
        return 0.0
    return (s_x - s_xy) / s_x


def _theils_u_compute(confmat: torch.Tensor) -> torch.Tensor:
    """Theil's U over the accumulated table: one host read, float32 on its device."""
    return _nominal_result(_theils_u_statistic(_host_table(confmat)), confmat.device)


def theils_u(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""Theil's U: how much knowing ``target`` reduces the uncertainty of ``preds``.
    It is asymmetric: ``U(preds | target) != U(target | preds)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import theils_u
        >>> preds = torch.tensor([0, 1, 2, 2, 1, 0, 1, 2, 0, 1])
        >>> target = torch.tensor([0, 1, 2, 1, 1, 0, 2, 2, 0, 0])
        >>> round(float(theils_u(preds, target)), 4)
        0.4427
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _nominal_dense_update(preds, target, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def theils_u_matrix(
    matrix: torch.Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[Union[int, float]] = 0.0,
) -> torch.Tensor:
    r"""The full, asymmetric matrix of Theil's U over the columns of ``matrix``: one
    table per unordered pair, ``U(j | i)`` from its transpose (one ``unique`` sync and
    one table read per pair)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_variables = matrix.shape[1]
    out = np.ones((num_variables, num_variables), dtype=np.float32)
    for i, j in itertools.combinations(range(num_variables), 2):
        cm = _host_table(_nominal_dense_update(matrix[:, i], matrix[:, j], nan_strategy, nan_replace_value))
        out[i, j] = _theils_u_statistic(cm)
        out[j, i] = _theils_u_statistic(cm.T)
    return torch.from_numpy(out).to(matrix.device)
