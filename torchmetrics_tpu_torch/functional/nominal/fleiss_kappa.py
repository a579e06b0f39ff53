"""Fleiss' kappa (counterpart of ``torchmetrics_tpu/functional/nominal/fleiss_kappa.py``).

The update and the compute stay on the device. Probs mode takes each rater's argmax
over the categories and counts it by comparison with the category indices, which reads
nothing back (``torch.nn.functional.one_hot`` checks its labels' range on the host).
"""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.utilities.data import _one_hot


def _fleiss_kappa_update(ratings: torch.Tensor, mode: str = "counts") -> torch.Tensor:
    """A per-sample category-count matrix ``(n_samples, n_categories)``: the ratings
    themselves in counts mode; in probs mode ``(n_samples, n_categories, n_raters)``
    scores, each rater's pick counted, int32."""
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        picked = ratings.argmax(dim=1)  # (n_samples, n_raters)
        return _one_hot(picked, ratings.shape[1]).sum(dim=1, dtype=torch.int32)
    if mode == "counts" and (ratings.ndim != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: torch.Tensor) -> torch.Tensor:
    """kappa = (p_bar - pe_bar) / (1 - pe_bar), float32 on the device, as the JAX
    package computes it (with its 1e-5 in the denominator)."""
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(dim=1).max()
    p_i = counts.sum(dim=0) / (total * num_raters)
    p_j = ((counts**2).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i**2).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: torch.Tensor, mode: str = "counts") -> torch.Tensor:
    r"""Fleiss' kappa, the agreement of raters on categories.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fleiss_kappa
        >>> ratings = torch.tensor([[2, 1, 0], [1, 1, 1], [0, 2, 1], [3, 0, 0]])
        >>> round(float(fleiss_kappa(ratings)), 4)
        0.0455
    """
    if mode not in ("counts", "probs"):
        raise ValueError("Argument ``mode`` must be one of ['counts', 'probs']")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))
