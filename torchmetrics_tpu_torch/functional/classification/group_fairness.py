"""Group fairness: per-group stat rates, demographic parity and equal opportunity
(counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``).

The per-group tp / fp / tn / fn are one count into ``4 * num_groups`` int32 bins
through the sync-free ``_bincount``: cell = group × 4 + (tp, fp, tn, fn). The JAX
package takes an int32 matmul of a ``(G, N)`` one-hot, which CUDA does not have (a
float matmul stops being exact past 2^24); the counts are the same. An ignored target,
or a group outside ``[0, num_groups)``, counts in no cell. The host reads stay where
the JAX package has them: the group range check under ``validate_args``, the number
of distinct groups in the functional forms, and the argmin / argmax group ids at
compute.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _bincount

_TASKS = ("demographic_parity", "equal_opportunity", "all")


def _groups_validation(groups: torch.Tensor, num_groups: int) -> None:
    """Group ids in ``[0, num_groups)`` and of an integer type (host reads)."""
    if int(groups.max()) > num_groups - 1 or int(groups.min()) < 0:
        raise ValueError(
            f"The largest number in the groups tensor is {int(groups.max())}, which is larger than the specified"
            f" number of groups {num_groups}."
        )
    if groups.is_floating_point() or groups.is_complex() or groups.dtype == torch.bool:
        raise ValueError(f"Excepted groups to be of integer type but got {groups.dtype}")


def _groups_format(groups: torch.Tensor) -> torch.Tensor:
    return groups.reshape(groups.shape[0], -1)


def _binary_groups_stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """``(num_groups, 4)`` int32 counts; the columns are tp, fp, tn, fn."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    g = _groups_format(groups).flatten().long()
    p, t = preds.flatten(), target.flatten()
    # t == 1: tp (0) when p == t, else fn (3); t == 0: tn (2) when p == t, else fp (1)
    kind = torch.where(t == 1, torch.where(p == t, 0, 3), torch.where(p == t, 2, 1))
    dropped = ((t != 0) & (t != 1)) | (g < 0) | (g >= num_groups)
    cell = torch.where(dropped, -1, g * 4 + kind)
    return _bincount(cell, minlength=4 * num_groups).reshape(num_groups, 4)


def _groups_reduce(counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Each group's [tp, fp, tn, fn] over its sample count; a group with no sample
    gives the documented zeros, not 0/0."""
    return {f"group_{group}": _safe_divide(row, row.sum()) for group, row in enumerate(counts)}


def _groups_stat_transform(counts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The ``(num_groups,)`` tp, fp, tn and fn vectors."""
    return {"tp": counts[:, 0], "fp": counts[:, 1], "tn": counts[:, 2], "fn": counts[:, 3]}


def binary_groups_stat_rates(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Per-group tp / fp / tn / fn rates.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_groups_stat_rates
        >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.1])
        >>> target = torch.tensor([1, 0, 0, 1])
        >>> groups = torch.tensor([0, 0, 1, 1])
        >>> {k: v.tolist() for k, v in binary_groups_stat_rates(preds, target, groups, 2).items()}
        {'group_0': [0.5, 0.0, 0.5, 0.0], 'group_1': [0.0, 0.5, 0.0, 0.5]}
    """
    return _groups_reduce(
        _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    )


def _compute_binary_demographic_parity(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor
) -> Dict[str, torch.Tensor]:
    pos_rates = _safe_divide(tp + fp, tp + fp + tn + fn)
    min_id, max_id = int(pos_rates.argmin()), int(pos_rates.argmax())
    return {f"DP_{min_id}_{max_id}": _safe_divide(pos_rates[min_id], pos_rates[max_id])}


def _compute_binary_equal_opportunity(
    tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor
) -> Dict[str, torch.Tensor]:
    tprs = _safe_divide(tp, tp + fn)
    min_id, max_id = int(tprs.argmin()), int(tprs.argmax())
    return {f"EO_{min_id}_{max_id}": _safe_divide(tprs[min_id], tprs[max_id])}


def _fairness_compute(counts: torch.Tensor, task: str) -> Dict[str, torch.Tensor]:
    transformed = _groups_stat_transform(counts)
    out: Dict[str, torch.Tensor] = {}
    if task in ("demographic_parity", "all"):
        out.update(_compute_binary_demographic_parity(**transformed))
    if task in ("equal_opportunity", "all"):
        out.update(_compute_binary_equal_opportunity(**transformed))
    return out


def _num_distinct_groups(groups: torch.Tensor) -> int:
    return torch.unique(groups).numel()


def _no_target(preds: torch.Tensor) -> torch.Tensor:
    return torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)


def demographic_parity(
    preds: torch.Tensor,
    groups: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """The ratio of the lowest to the highest positivity rate across the groups."""
    counts = _binary_groups_stat_scores(
        preds, _no_target(preds), groups, _num_distinct_groups(groups), threshold, ignore_index, validate_args
    )
    return _fairness_compute(counts, "demographic_parity")


def equal_opportunity(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """The ratio of the lowest to the highest true positive rate across the groups."""
    counts = _binary_groups_stat_scores(
        preds, target, groups, _num_distinct_groups(groups), threshold, ignore_index, validate_args
    )
    return _fairness_compute(counts, "equal_opportunity")


def _fairness_task_validation(task: str) -> None:
    if task not in _TASKS:
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )


def binary_fairness(
    preds: torch.Tensor,
    target: torch.Tensor,
    groups: torch.Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, torch.Tensor]:
    """Demographic parity and / or equal opportunity."""
    _fairness_task_validation(task)
    num_groups = _num_distinct_groups(groups)
    if task == "demographic_parity":
        target = _no_target(preds)
    counts = _binary_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index, validate_args)
    return _fairness_compute(counts, task)
