"""Pairwise cosine similarity (counterpart of ``torchmetrics_tpu/functional/pairwise/cosine.py``).

The rows are normalized, then one ``torch.matmul`` (float32 at PyTorch's default
``"highest"`` precision, as ``linear.py`` says).
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal


def _pairwise_cosine_similarity_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    """Row-normalize (a zero row stays zero), then one matmul."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    norm_x = torch.linalg.norm(x, dim=1, keepdim=True)
    norm_y = torch.linalg.norm(y, dim=1, keepdim=True)
    x_normed = x / torch.where(norm_x == 0, 1.0, norm_x)
    y_normed = y / torch.where(norm_y == 0, 1.0, norm_y)
    return _zero_diagonal(x_normed @ y_normed.T, zero_diagonal)


def pairwise_cosine_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    r"""Pairwise cosine similarity between the rows of ``x`` (and ``y``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[2.0, 3.0], [3.0, 5.0], [5.0, 8.0]])
        >>> y = torch.tensor([[1.0, 0.0], [2.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    distance = _pairwise_cosine_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)
