"""Concordance correlation coefficient (counterpart of
``torchmetrics_tpu/functional/regression/concordance.py``).

From the Pearson moments: CCC = 2ρσ_xσ_y / (σ_x² + σ_y² + (μ_x − μ_y)²).
"""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_compute, _pearson_corrcoef_update


def _concordance_corrcoef_compute(
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    nb: torch.Tensor,
) -> torch.Tensor:
    """CCC from accumulated moments, with sample variances (÷(n−1))."""
    pearson = _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    return 2.0 * pearson * torch.sqrt(var_x) * torch.sqrt(var_y) / (var_x + var_y + (mean_x - mean_y) ** 2)


def concordance_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Concordance correlation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import concordance_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(concordance_corrcoef(preds, target)), 4)
        0.9777
    """
    d = preds.shape[1] if preds.ndim == 2 else 1
    _temp = torch.zeros(d, dtype=torch.promote_types(preds.dtype, torch.float32), device=preds.device).squeeze()
    mean_x, mean_y, var_x = _temp, _temp, _temp
    var_y, corr_xy, nb = _temp, _temp, _temp
    mean_x, mean_y, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(
        preds, target, mean_x, mean_y, var_x, var_y, corr_xy, nb,
        num_outputs=1 if preds.ndim == 1 else preds.shape[-1],
    )
    return _concordance_corrcoef_compute(mean_x, mean_y, var_x, var_y, corr_xy, nb)
