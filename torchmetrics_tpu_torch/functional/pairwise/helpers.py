"""Shared input checks, reductions and row blocks of the pairwise matrices
(counterpart of ``torchmetrics_tpu/functional/pairwise/helpers.py``)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

# the largest temporary a broadcast distance may build: 1 GiB
_BLOCK_BYTES = 1 << 30


def _check_input(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Validate the shapes and resolve the ``zero_diagonal`` default: on for ``x``
    against itself, off against a given ``y``."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {x.shape}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: torch.Tensor, reduction: Optional[str] = None) -> torch.Tensor:
    """The row-wise mean or sum, or the whole matrix."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _zero_diagonal(distmat: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    """Zero the diagonal (of a non-square matrix too) in place: every caller hands in a
    matrix it has just made."""
    if zero_diagonal:
        distmat.diagonal().zero_()
    return distmat


def _row_blocks(
    x: torch.Tensor, y: torch.Tensor, rows_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """``rows_fn(x[block], y)`` over blocks of rows of ``x``, concatenated: a block's
    ``(rows, M, d)`` broadcast temporary stays within ``_BLOCK_BYTES``. Each output
    element is the same reduction over ``d`` as without blocks."""
    per_row = max(1, y.shape[0] * y.shape[1] * x.element_size())
    rows = max(1, _BLOCK_BYTES // per_row)
    return torch.cat([rows_fn(x[start:start + rows], y) for start in range(0, x.shape[0], rows)])
