"""Pairwise linear similarity (counterpart of ``torchmetrics_tpu/functional/pairwise/linear.py``).

One ``torch.matmul``. On the card a float32 product is exact to float32 only at
``torch.get_float32_matmul_precision() == "highest"`` (PyTorch's default: no TF32);
the port does not change that setting.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal


def _pairwise_linear_similarity_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    """The inner-product matrix ``x y^T``."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(x @ y.T, zero_diagonal)


def pairwise_linear_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise linear similarity between the rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
        >>> y = torch.tensor([[1.0, 2.5], [2.5, 4.0], [5.5, 6.5]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 6.0000, 10.5000, 18.5000],
                [13.0000, 23.5000, 42.5000],
                [20.0000, 36.5000, 66.5000]])
    """
    distance = _pairwise_linear_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
