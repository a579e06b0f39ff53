"""Kendall rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/kendall.py``).

The pair scan compares a block of rows with every element, so memory stays
O(block · n) and no (n, n) matrix is built. Concordant and discordant pairs and the
tie sums Σ(t − 1), Σ(t − 1)(t − 2) and Σ(t − 1)(2t + 5) over elements are counted in
int64, which is exact, so the block size cannot change them; the statistics are
float64, and tau and the p-value are rounded once to float32. Every element of a tie
group of size t sees t equal values in its row, so Σ over groups of f(t) is Σ over
elements of f(c_i) / c_i, with no grouping. Each pair is seen twice over full rows
(i < j and j < i, the same sign product), so the pair counts are halved. The distinct
counts (tau-c's m) are the run starts of the sorted column, an exact integer: a float
Σ 1/t over elements lands a hair off an integer at some sizes, and a constant column
then gives ±0.0 where (m - 1) / m is exactly 0 and tau-c is NaN.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape
from torchmetrics_tpu_torch.utilities.enums import EnumStr


class _MetricVariant(EnumStr):
    """Tau variant."""

    A = "a"
    B = "b"
    C = "c"

    @classmethod
    def _name(cls) -> str:
        return "variant"


class _TestAlternative(EnumStr):
    """Alternative hypothesis of the test."""

    TWO_SIDED = "two-sided"
    LESS = "less"
    GREATER = "greater"

    @classmethod
    def _name(cls) -> str:
        return "alternative"


# elements of one block's (block, n) comparison: 2^24 float32 differences are 64 MiB
_PAIR_ELEMENTS = 1 << 24


def _kendall_stats_1d(x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
    """The pair statistics of one (n,) pair, each pair counted from both its rows:
    concordant, discordant, Σ(t−1) of x and of y, Σ(t−1)(t−2) and Σ(t−1)(2t+5) of x,
    the same of y (int64), and the distinct values of x and of y (int64)."""
    n = x.shape[0]
    block = max(1, min(n, _PAIR_ELEMENTS // max(n, 1)))
    sums = torch.zeros(8, dtype=torch.int64, device=x.device)
    for start in range(0, n, block):
        dx = x[start:start + block, None] - x[None, :]
        dy = y[start:start + block, None] - y[None, :]
        prod = torch.sign(dx) * torch.sign(dy)
        cx = (dx == 0).sum(dim=1)
        cy = (dy == 0).sum(dim=1)
        sums += torch.stack([
            (prod > 0).sum(),
            (prod < 0).sum(),
            (cx - 1).sum(),
            (cy - 1).sum(),
            ((cx - 1) * (cx - 2)).sum(),
            ((cx - 1) * (2 * cx + 5)).sum(),
            ((cy - 1) * (cy - 2)).sum(),
            ((cy - 1) * (2 * cy + 5)).sum(),
        ])
    return [*sums.unbind(), _distinct(x), _distinct(y)]


def _distinct(x: torch.Tensor) -> torch.Tensor:
    """The number of tie groups, int64: the run starts of the sorted values. ``-0.0``
    ties with ``0.0`` and each NaN is a group of its own, as the pair scan's ``== 0``
    sees them."""
    v = torch.sort(x).values
    return (v[1:] != v[:-1]).sum() + min(x.shape[0], 1)


def _calculate_tau(stats: Tuple[torch.Tensor, ...], n_total: torch.Tensor, variant: _MetricVariant) -> torch.Tensor:
    """Tau from the pair statistics, float64."""
    con, dis, ties_x, ties_y, _, _, _, _, nux, nuy = stats
    con_min_dis = (con - dis).to(torch.float64)
    if variant == _MetricVariant.A:
        return con_min_dis / (con + dis)
    if variant == _MetricVariant.B:
        n0 = n_total * (n_total - 1) / 2
        return con_min_dis / torch.sqrt((n0 - ties_x) * (n0 - ties_y))
    min_classes = torch.minimum(nux, nuy)
    return 2 * con_min_dis / ((min_classes - 1) / min_classes * n_total**2)


def _calculate_p_value(
    stats: Tuple[torch.Tensor, ...],
    n_total: torch.Tensor,
    variant: _MetricVariant,
    alternative: Optional[_TestAlternative],
) -> torch.Tensor:
    """The asymptotic normal p-value with the tie correction, float64."""
    con, dis, ties_x, ties_y, x_p1, x_p2, y_p1, y_p2, _, _ = stats
    con_min_dis = (con - dis).to(torch.float64)
    base = n_total * (n_total - 1) * (2 * n_total + 5)
    if variant == _MetricVariant.A:
        t_value = 3 * con_min_dis / torch.sqrt(base / 2)
    else:
        m = n_total * (n_total - 1)
        denom = (base - x_p2 - y_p2) / 18
        denom = denom + (2 * ties_x * ties_y) / m
        denom = denom + x_p1 * y_p1 / (9 * m * (n_total - 2))
        t_value = con_min_dis / torch.sqrt(denom)

    if alternative == _TestAlternative.TWO_SIDED:
        t_value = torch.abs(t_value)
    if alternative in (_TestAlternative.TWO_SIDED, _TestAlternative.GREATER):
        t_value = -t_value
    p_value = torch.special.ndtr(t_value)
    if alternative == _TestAlternative.TWO_SIDED:
        p_value = p_value * 2
    return p_value


def _kendall_corrcoef_update(
    preds: torch.Tensor, target: torch.Tensor, num_outputs: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the batch and give it the (n, outputs) shape of the list states."""
    _check_same_shape(preds, target)
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    if num_outputs == 1 and preds.ndim == 1:
        preds = preds[:, None]
        target = target[:, None]
    return preds, target


def _kendall_corrcoef_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    variant: _MetricVariant,
    alternative: Optional[_TestAlternative] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tau (and the p-value when ``alternative`` is set) over ``(n, outputs)`` data,
    one output at a time."""
    per_output = [_kendall_stats_1d(preds[:, i], target[:, i]) for i in range(preds.shape[1])]
    counts = [torch.stack(s).to(torch.float64) for s in zip(*per_output)]
    # the pair counts halve exactly: each pair was counted from both of its rows
    counts[0], counts[1], counts[2], counts[3] = counts[0] / 2, counts[1] / 2, counts[2] / 2, counts[3] / 2
    stats = tuple(counts)
    # a fill on the device: a tensor made from a host value would be a copy to the card
    n_total = torch.full((), float(preds.shape[0]), dtype=torch.float64, device=preds.device)
    tau = _calculate_tau(stats, n_total, variant)
    p_value = _calculate_p_value(stats, n_total, variant, alternative) if alternative is not None else None
    tau = torch.clamp(tau.squeeze(), -1.0, 1.0).to(torch.float32)
    if p_value is not None:
        p_value = p_value.squeeze().to(torch.float32)
    return tau, p_value


def kendall_rank_corrcoef(
    preds: torch.Tensor,
    target: torch.Tensor,
    variant: str = "b",
    t_test: bool = False,
    alternative: Optional[str] = "two-sided",
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Kendall's tau, and its p-value when ``t_test``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kendall_rank_corrcoef
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(kendall_rank_corrcoef(preds, target)), 4)
        1.0
    """
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` is expected to be of a type `bool`, but got {type(t_test)}.")
    if t_test and alternative is None:
        raise ValueError("Argument `alternative` is required if `t_test=True` but got `None`.")
    _variant = _MetricVariant.from_str(str(variant))
    _alternative = _TestAlternative.from_str(str(alternative)) if t_test else None

    preds2, target2 = _kendall_corrcoef_update(preds, target, num_outputs=1 if preds.ndim == 1 else preds.shape[-1])
    tau, p_value = _kendall_corrcoef_compute(preds2, target2, _variant, _alternative)
    if p_value is not None:
        return tau, p_value
    return tau
