"""Shared machinery of the nominal association statistics (counterpart of
``torchmetrics_tpu/functional/nominal/utils.py``).

The update counts label pairs into an int32 ``(C, C)`` table on the device; the
statistic is an epoch-end scalar over that table with its empty rows and columns
dropped (a data-dependent shape), so ``compute`` reads the table to the host once and
computes in float64 numpy, as the JAX package does, and returns float32 on the table's
device.

``nan_strategy="drop"`` reads nothing back: a dropped row's codes become ``-1``, which
the confusion-matrix count drops, where the JAX package drops the rows by boolean
indexing (a data-dependent shape). The counts are equal, and the update can run as a
captured graph. A float code outside ``(-1, num_classes)`` (``"replace"`` turns ±inf
into the dtype's extremes) is dropped in both packages: the JAX cast saturates to an
out-of-range int32, the port sends it to ``-1`` before its cast.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confusion_matrix_update
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[Union[int, float]]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (int, float)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _nominal_labels(
    preds: torch.Tensor, target: torch.Tensor, nan_strategy: str, nan_replace_value: Optional[Union[int, float]]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Logits ``(N, C)`` to labels (argmax: the first index wins a tie, NaN is maximal),
    NaN replaced, or the rows to drop as a mask (``None`` when nothing can be dropped)."""
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    target = target.argmax(1) if target.ndim == 2 else target
    if nan_strategy == "replace":
        preds, target = (torch.nan_to_num(x, nan=nan_replace_value) if x.is_floating_point() else x for x in (preds, target))
        return preds, target, None
    drop = None
    for x in (preds, target):
        if x.is_floating_point():
            drop = torch.isnan(x) if drop is None else drop | torch.isnan(x)
    return preds, target, drop


def _codes(x: torch.Tensor, num_classes: int, drop: Optional[torch.Tensor]) -> torch.Tensor:
    """Int32 codes, ``-1`` where the row is dropped or a float lies outside
    ``(-1, num_classes)``; a float in range truncates toward zero, as the JAX cast does."""
    if x.is_floating_point():
        out_of_range = ~((x > -1) & (x < num_classes))
        drop = out_of_range if drop is None else drop | out_of_range
        x = torch.where(drop, -1, x)
    elif drop is not None:
        x = torch.where(drop, -1, x)
    return x.to(torch.int32)


def _nominal_bins_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    nan_strategy: str,
    nan_replace_value: Optional[Union[int, float]],
) -> torch.Tensor:
    """The modular update: labels must be dense codes ``0..num_classes-1`` (values
    outside are dropped, as in the JAX package). Reads nothing back to the host."""
    preds, target, drop = _nominal_labels(preds, target, nan_strategy, nan_replace_value)
    return _multiclass_confusion_matrix_update(
        _codes(preds, num_classes, drop), _codes(target, num_classes, drop), num_classes
    )


def _nominal_dense_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    nan_strategy: str,
    nan_replace_value: Optional[Union[int, float]],
) -> torch.Tensor:
    """The functional update: any category values (floats, sparse integers) become
    dense codes through ``torch.unique(..., return_inverse=True)`` over both columns,
    one host sync (the number of distinct values sizes the table), as the JAX package's
    ``np.unique`` is. A dropped row's values are counted as 0 in the unique set and its
    codes become ``-1``: an extra value only adds an empty row and column, which
    ``compute`` drops."""
    preds, target, drop = _nominal_labels(preds, target, nan_strategy, nan_replace_value)
    values = torch.cat([preds.reshape(-1), target.reshape(-1)])
    if drop is not None:
        values = torch.where(torch.cat([drop.reshape(-1)] * 2), 0, values)
    uniq, inverse = torch.unique(values, return_inverse=True)
    n = preds.numel()
    p_codes, t_codes = inverse[:n], inverse[n:]
    if drop is not None:
        p_codes, t_codes = (torch.where(drop.reshape(-1), -1, c) for c in (p_codes, t_codes))
    return _multiclass_confusion_matrix_update(p_codes, t_codes, uniq.numel())


def _host_table(confmat: torch.Tensor) -> np.ndarray:
    """The table as float64 numpy with its empty rows and columns dropped: the one host
    read of a ``compute``."""
    return _drop_empty_rows_and_cols(confmat.cpu().numpy().astype(np.float64))


def _nominal_result(value: float, device: torch.device) -> torch.Tensor:
    """A float32 scalar on ``device``, made by a fill: a tensor built from a host value
    would be one more copy to the card."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _drop_empty_rows_and_cols(confmat: np.ndarray) -> np.ndarray:
    """Drop all-zero rows and columns."""
    confmat = confmat[confmat.sum(1) != 0]
    return confmat[:, confmat.sum(0) != 0]


def _compute_expected_freqs(confmat: np.ndarray) -> np.ndarray:
    """Outer product of the margins over the total."""
    margin_rows, margin_cols = confmat.sum(1), confmat.sum(0)
    return np.outer(margin_rows, margin_cols) / confmat.sum()


def _compute_chi_squared(confmat: np.ndarray, bias_correction: bool) -> float:
    """Chi-square test of independence, with scipy's Yates correction at df = 1."""
    expected_freqs = _compute_expected_freqs(confmat)
    df = expected_freqs.size - sum(expected_freqs.shape) + expected_freqs.ndim - 1
    if df == 0:
        return 0.0
    if df == 1 and bias_correction:
        diff = expected_freqs - confmat
        direction = np.sign(diff)
        confmat = confmat + direction * np.minimum(0.5, np.abs(diff))
    return float(np.sum((confmat - expected_freqs) ** 2 / expected_freqs))


def _compute_bias_corrected_values(
    phi_squared: float, n_rows: int, n_cols: int, cm_sum: float
) -> Tuple[float, float, float]:
    """Bias-corrected phi squared and effective table shape."""
    phi_squared_corrected = max(0.0, phi_squared - ((n_rows - 1) * (n_cols - 1)) / (cm_sum - 1))
    rows_corrected = n_rows - (n_rows - 1) ** 2 / (cm_sum - 1)
    cols_corrected = n_cols - (n_cols - 1) ** 2 / (cm_sum - 1)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )


def _pairwise_matrix(
    matrix: torch.Tensor, statistic: Callable[[np.ndarray], float], nan_strategy: str,
    nan_replace_value: Optional[Union[int, float]],
) -> torch.Tensor:
    """The symmetric float32 matrix of ``statistic`` over every pair of the dataset's
    columns, ones on the diagonal: one ``unique`` sync and one table read per pair."""
    num_variables = matrix.shape[1]
    out = np.ones((num_variables, num_variables), dtype=np.float32)
    for i, j in itertools.combinations(range(num_variables), 2):
        confmat = _nominal_dense_update(matrix[:, i], matrix[:, j], nan_strategy, nan_replace_value)
        out[i, j] = out[j, i] = statistic(_host_table(confmat))
    return torch.from_numpy(out).to(matrix.device)
