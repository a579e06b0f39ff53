"""Pairwise minkowski distance (counterpart of ``torchmetrics_tpu/functional/pairwise/minkowski.py``).

Built in blocks of rows as ``manhattan.py`` is, with the same values as the JAX
package's one broadcast.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from torchmetrics_tpu_torch.functional.pairwise.helpers import (
    _check_input,
    _reduce_distance_matrix,
    _row_blocks,
    _zero_diagonal,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError


def _pairwise_minkowski_distance_update(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    exponent: Union[int, float] = 2,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """``(Σ_d |x_i - y_j|^p)^(1/p)`` over blocks of rows."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise TorchMetricsUserError(
            f"Argument ``p`` must be a float or int greater than or equal to 1, but got {exponent}"
        )

    def rows(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        diff = (xb[:, None, :] - yb[None, :, :]).abs_()
        # in place where the power keeps the dtype: integer rows raised to a float power are not
        diff = diff.pow_(exponent) if diff.is_floating_point() else diff**exponent
        return diff.sum(dim=-1) ** (1.0 / exponent)

    return _zero_diagonal(_row_blocks(x, y, rows), zero_diagonal)


def pairwise_minkowski_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    exponent: Union[int, float] = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise minkowski distances of order ``exponent`` between the rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_minkowski_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        >>> y = torch.tensor([[1.0, 2.5], [2.5, 4.0], [5.5, 6.5]])
        >>> pairwise_minkowski_distance(x, y, exponent=4).round(decimals=4)
        tensor([[0.5000, 2.1423, 5.3514],
                [2.1423, 0.5000, 2.9730],
                [4.4890, 2.7240, 0.5946]])
    """
    distance = _pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
