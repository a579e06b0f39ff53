"""Permutation-invariant training (counterpart of ``torchmetrics_tpu/functional/audio/pit.py``).

Speaker-wise mode evaluates every (target, prediction) speaker pair in ONE batched
metric call over a ``(batch * S * S)`` layout. For ``S <= 3`` the best assignment is an
exhaustive search over the ``S!`` permutations on the device: one gather and one
reduction against a permutation table built once per ``(S, device)``, so a captured
update holds it as a constant. Ties go to the first permutation, and a row whose every
value is NaN to permutation 0, as ``argmax`` / ``argmin`` give it in both packages.
Beyond that, scipy's Hungarian solver runs on the host after one device-to-host copy of
the ``(B, S, S)`` matrix per call; under the update engine that read makes the step
fall back (``host-read:linear_sum_assignment``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

_EXHAUSTIVE_SPK_LIMIT = 3  # S! permutations on the device up to here; Hungarian beyond

# (permutations (P, S), speaker index (1, S)) of each (S, device), built once
_PERMUTATIONS: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def _gen_permutations(spk_num: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """All permutations of ``range(spk_num)`` in ``itertools.permutations`` order, as
    ``(perm_num, spk_num)`` int64, and the ``(1, spk_num)`` speaker index, on ``device``.

    Built on the device from ``arange`` (no host data enters, so a guarded first step
    may build it): permutation ``p``'s Lehmer code has digit ``(p // (S - 1 - i)!) %
    (S - i)`` at slot ``i``, the rank of its pick among the speakers still free.
    """
    device = torch.device(device)
    key = (spk_num, device)
    table = _PERMUTATIONS.get(key)
    if table is None:
        speakers = torch.arange(spk_num, device=device)[None, :]
        p = torch.arange(math.factorial(spk_num), device=device)
        free = torch.ones((p.shape[0], spk_num), dtype=torch.bool, device=device)
        picks = []
        for i in range(spk_num):
            digit = (p // math.factorial(spk_num - 1 - i)) % (spk_num - i)
            rank = free.to(torch.int64).cumsum(dim=1) - 1
            pick = ((rank == digit[:, None]) & free).to(torch.int64).argmax(dim=1)
            picks.append(pick)
            free = free & (speakers != pick[:, None])
        table = _PERMUTATIONS[key] = (torch.stack(picks, dim=1), speakers)
    return table


def _find_best_perm_by_exhaustive_method(
    metric_mtx: torch.Tensor, maximize: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score all ``S!`` assignments with one gather and one reduction."""
    perms, speakers = _gen_permutations(metric_mtx.shape[-1], metric_mtx.device)
    # metric_of_ps[b, p] = mean_s metric_mtx[b, s, perms[p, s]]
    metric_of_ps = metric_mtx[:, speakers, perms].mean(dim=-1)  # (B, P)
    best_indexes = metric_of_ps.argmax(dim=-1) if maximize else metric_of_ps.argmin(dim=-1)
    best_metric = metric_of_ps.gather(-1, best_indexes[:, None])[:, 0]
    return best_metric, perms[best_indexes]


def _find_best_perm_by_linear_sum_assignment(
    metric_mtx: torch.Tensor, maximize: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hungarian solve on the host for larger speaker counts: one read of the matrix."""
    from scipy.optimize import linear_sum_assignment

    from torchmetrics_tpu_torch.engine.compiled import _Ineligible, in_traced_body

    if in_traced_body():
        # the read below would leave a captured graph without this step's values
        raise _Ineligible("host-read:linear_sum_assignment")
    mtx = metric_mtx.detach().cpu().numpy()
    best = np.stack([linear_sum_assignment(m, maximize)[1] for m in mtx])
    # a copy from pageable host memory: the host stages it, and the device does not wait
    best_perm = torch.from_numpy(best).to(metric_mtx.device, non_blocking=True)
    best_metric = metric_mtx.gather(2, best_perm[:, :, None]).mean(dim=(-1, -2))
    return best_metric, best_perm


def permutation_invariant_training(
    preds: torch.Tensor,
    target: torch.Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best metric value and speaker assignment per sample.

    ``preds`` / ``target`` are ``(batch, spk, ...)``; ``metric_func`` maps batched
    ``(preds, target)`` pairs to ``(batch,)`` values.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import (
        ...     permutation_invariant_training, scale_invariant_signal_distortion_ratio)
        >>> target = torch.sin(torch.arange(200.0)[None, None] * torch.tensor([0.1, 0.3])[None, :, None])
        >>> preds = target.flip(1) + 0.01 * torch.cos(torch.arange(200.0))
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio)
        >>> best_perm
        tensor([[1, 0]])
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    maximize = eval_func == "max"
    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        # the metric on whole permutations (joint metrics), in one batched call
        perms, _ = _gen_permutations(spk_num, preds.device)  # (P, S)
        perm_num = perms.shape[0]
        ppreds = preds[:, perms].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = target[:, None].expand(batch_size, perm_num, *target.shape[1:]).reshape(ppreds.shape)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = metric_of_ps.reshape(batch_size, perm_num, -1).mean(dim=-1)
        best_indexes = metric_of_ps.argmax(dim=-1) if maximize else metric_of_ps.argmin(dim=-1)
        best_metric = metric_of_ps.gather(-1, best_indexes[:, None])[:, 0]
        return best_metric, perms[best_indexes]

    # speaker-wise: all S * S pairs in one metric call
    rest = preds.shape[2:]
    preds_pairs = preds[:, None].expand(batch_size, spk_num, spk_num, *rest)
    target_pairs = target[:, :, None].expand(batch_size, spk_num, spk_num, *rest)
    flat_metric = metric_func(
        preds_pairs.reshape(batch_size * spk_num * spk_num, *rest),
        target_pairs.reshape(batch_size * spk_num * spk_num, *rest),
        **kwargs,
    )
    metric_mtx = flat_metric.reshape(batch_size, spk_num, spk_num)  # [b, target, pred]

    if spk_num <= _EXHAUSTIVE_SPK_LIMIT:
        return _find_best_perm_by_exhaustive_method(metric_mtx, maximize)
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, maximize)


def pit_permutate(preds: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorder the speakers of ``preds`` by ``perm`` (``(batch, spk)``)."""
    index = perm.reshape(*perm.shape, *(1,) * (preds.ndim - 2)).expand(*perm.shape, *preds.shape[2:])
    return preds.gather(1, index)
