"""Pairwise manhattan distance (counterpart of ``torchmetrics_tpu/functional/pairwise/manhattan.py``).

The JAX package broadcasts one ``(N, M, d)`` temporary; the port builds it in blocks
of rows of ``x`` (``helpers._row_blocks``, at most 1 GiB each), with the same values.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _row_blocks,
    _zero_diagonal,
)


def _manhattan_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x[:, None, :] - y[None, :, :]).abs_().sum(dim=-1)


def _pairwise_manhattan_distance_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    """``Σ_d |x_i - y_j|`` over blocks of rows."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_row_blocks(x, y, _manhattan_rows), zero_diagonal)


def pairwise_manhattan_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise manhattan distances between the rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        >>> y = torch.tensor([[1.0, 2.5], [2.5, 4.0], [5.5, 6.5]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[0.5000, 3.5000, 9.0000],
                [3.5000, 0.5000, 5.0000],
                [7.5000, 4.5000, 1.0000]])
    """
    distance = _pairwise_manhattan_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
