"""Pairwise euclidean distance (counterpart of ``torchmetrics_tpu/functional/pairwise/euclidean.py``).

``sqrt(|x|^2 + |y|^2 - 2 x y^T)``: the norm algebra runs in float64 and is cast back
to the input's dtype, since in float32 the difference of large squared norms cancels.
The JAX package does the same under x64 (its tests' setting), and so does upstream
torchmetrics.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal


def _pairwise_euclidean_distance_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    """Squared norms and one float64 matmul, cast back, clamped at 0, square-rooted."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    xd, yd = x.to(torch.float64), y.to(torch.float64)
    x_norm = (xd * xd).sum(dim=1, keepdim=True)
    y_norm = (yd * yd).sum(dim=1)
    distance = (x_norm + y_norm - 2 * xd @ yd.T).to(x.dtype)
    distance = _zero_diagonal(distance, zero_diagonal)
    return torch.sqrt(torch.clamp(distance, min=0.0))


def pairwise_euclidean_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise euclidean distances between the rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
        >>> pairwise_euclidean_distance(x).round(decimals=1).tolist()
        [[0.0, 5.0], [5.0, 0.0]]
    """
    distance = _pairwise_euclidean_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
