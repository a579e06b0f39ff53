"""Precision-recall curves for binary, multiclass and multilabel tasks, the base of the
curve family (ROC, AUROC, average precision), and the task router.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
Two modes:

* binned (``thresholds`` given): the state is a fixed ``(T, [C,] 2, 2)`` confusion
  tensor per threshold, counted by kernel K2 (``ops/multi_threshold.py``): binary at
  ``(N, 1)``, multiclass with a broadcast ``(N, 1)`` row mask, multilabel with a
  per-element ``(N, L)`` mask;
* exact (``thresholds=None``): the scores and targets are kept, and the curve is a
  sort over all of them at compute time, in plain PyTorch.

Ignored targets become ``-1`` (multilabel: the score and the target both become
``-4 * L * T``, or ``-4 * L`` in exact mode, as in the JAX package, whose exact-mode
state holds that value) and are masked out. The check that every score lies in
[0, 1] before the sigmoid or softmax is a device -> host sync per update, as in the
JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _label_values_check
from torchmetrics_tpu_torch.ops.multi_threshold import multi_threshold_confmat, sort_thresholds
from torchmetrics_tpu_torch.utilities.checks import _check_same_shape, _is_floating
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, _sigmoid
from torchmetrics_tpu_torch.utilities.data import _cumsum
from torchmetrics_tpu_torch.utilities.enums import _route_task

Thresholds = Optional[Union[int, List[float], torch.Tensor]]
SortedThresholds = Tuple[torch.Tensor, torch.Tensor]


def _binary_clf_curve(
    preds: torch.Tensor, target: torch.Tensor, pos_label: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fps / tps at every distinct score, scores in descending order."""
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc = torch.argsort(-preds, stable=True)
    preds = preds[desc]
    target = target[desc]
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).flatten()
    last = torch.tensor([target.shape[0] - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])
    target = (target == pos_label).to(torch.int64)
    tps = _cumsum(target, dim=0)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _binned_multi_threshold_confmat(
    preds: torch.Tensor,
    positive: torch.Tensor,
    valid: torch.Tensor,
    thresholds: SortedThresholds,
) -> torch.Tensor:
    """``(T, C, 2, 2)`` int32 confusion tensor for every threshold, from kernel K2 alone.

    Args:
        preds: ``(N, C)`` scores.
        positive: ``(N, C)`` 0/1 ground-truth membership.
        valid: ``(N, C)`` mask of samples to count.
        thresholds: sorted thresholds and the order that sorted them (``sort_thresholds``).
    """
    return multi_threshold_confmat(preds, positive, valid, *thresholds)


def _adjust_threshold_arg(thresholds: Thresholds = None, device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    """int -> linspace, list -> tensor, both float32 on ``device``.

    The linspace is the one ``jnp.linspace(0, 1, T)`` gives in float32, bit for bit:
    ``float32(i) * float32(1 / (T - 1))`` with the last value set to 1.0 (PyTorch's own
    ``linspace`` differs by one ulp at some points, and a score on a threshold would bin
    apart). It is taken on the CPU and moved, so every device bins against the same
    values.
    """
    if isinstance(thresholds, int):
        step = torch.tensor(1 / max(thresholds - 1, 1), dtype=torch.float32)
        grid = torch.arange(thresholds, dtype=torch.float32) * step
        if thresholds > 1:
            grid[-1] = 1.0
        return grid.to(device)
    if isinstance(thresholds, list):
        return torch.tensor(thresholds, dtype=torch.float32, device=device)
    if isinstance(thresholds, torch.Tensor):
        return thresholds.to(device)
    return thresholds


def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if thresholds is not None and not isinstance(thresholds, (list, int, torch.Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, list) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            "If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, torch.Tensor) and not thresholds.ndim == 1:
        raise ValueError("If argument `thresholds` is an tensor, expected the tensor to be 1d")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, ignore_index: Optional[int] = None
) -> None:
    """Shape, dtype and value checks; the unique-value check is a device -> host sync."""
    _check_same_shape(preds, target)
    if _is_floating(target):
        raise ValueError(
            "Expected argument `target` to be an int or long tensor with ground truth labels"
            f" but got tensor with dtype {target.dtype}"
        )
    if not _is_floating(preds):
        raise ValueError(
            "Expected argument `preds` to be an floating tensor with probability/logit scores,"
            f" but got tensor with dtype {preds.dtype}"
        )
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    _label_values_check(target, allowed, "target", str(sorted(allowed)))


def _all_in_unit_interval(preds: torch.Tensor) -> bool:
    """Whether every score lies in [0, 1] (read back: a device -> host sync)."""
    return bool(((preds >= 0) & (preds <= 1)).all())


def _binary_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Flatten; ignored targets -> -1; sigmoid unless every score lies in [0, 1]."""
    preds = preds.flatten()
    target = target.flatten()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    if not _all_in_unit_interval(preds):
        preds = _sigmoid(preds)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Binned: ``(T, 2, 2)`` via K2 at ``C = 1``; exact: the scores and targets themselves."""
    if thresholds is None:
        return preds, target
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    confmat = _binned_multi_threshold_confmat(
        preds.to(torch.float32).contiguous()[:, None], (target > 0)[:, None], (target >= 0)[:, None], sorted_thresholds
    )
    return confmat[:, 0]


def _binary_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    thresholds: Optional[torch.Tensor],
    pos_label: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binned: precision and recall at every threshold; exact: drops ignored (-1)
    targets and sorts all scores."""
    if isinstance(state, torch.Tensor):
        tps = state[:, 1, 1]
        fps = state[:, 0, 1]
        fns = state[:, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds

    preds, target = state
    keep = target >= 0
    preds, target = preds[keep], target[keep]
    fps, tps, thresh = _binary_clf_curve(preds, target, pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = torch.cat([precision.flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall.flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresh.flip(0)


def binary_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PR curve for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_precision_recall_curve
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> [tuple(v.shape) for v in binary_precision_recall_curve(preds, target, thresholds=5)]
        [(6,), (6,), (5,)]
    """
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_precision_recall_curve_compute(state, thresholds)


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """Shape and value checks; counting unique targets is a device -> host sync."""
    if not preds.ndim == target.ndim + 1:
        raise ValueError(
            f"Expected `preds` to have one more dimension than `target` but got {preds.ndim} and {target.ndim}"
        )
    if _is_floating(target):
        raise ValueError(
            f"Expected argument `target` to be an int or long tensor, but got tensor with dtype {target.dtype}"
        )
    if not _is_floating(preds):
        raise ValueError(f"Expected `preds` to be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(
            "Expected `preds.shape[1]` to be equal to the number of classes but"
            f" got {preds.shape[1]} and {num_classes}."
        )
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError(
            "Expected the shape of `preds` should be (N, C, ...) and the shape of `target` should be (N, ...)"
            f" but got {preds.shape} and {target.shape}"
        )
    num_unique_values = torch.unique(target).numel()
    check = num_unique_values > num_classes if ignore_index is None else num_unique_values > num_classes + 1
    if check:
        raise RuntimeError(
            "Detected more unique values in `target` than `num_classes`. Expected only "
            f"{num_classes if ignore_index is None else num_classes + 1} but found "
            f"{num_unique_values} in `target`."
        )


def _multiclass_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """To ``(N, C)`` scores and flat targets; ignored -> -1; softmax unless all scores
    lie in [0, 1] (that check is a device -> host sync)."""
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    target = target.flatten()
    if ignore_index is not None:
        target = torch.where(target == ignore_index, -1, target)
    if not _all_in_unit_interval(preds):
        preds = preds.softmax(dim=1)
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multiclass_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Binned: ``(T, C, 2, 2)`` via K2; exact: the scores and targets themselves.

    ``sorted_thresholds`` is ``sort_thresholds(thresholds)`` when the caller keeps it.
    """
    if thresholds is None:
        return preds, target
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    valid = target >= 0
    # bool one-hot (1 byte per element) and the row mask broadcast with stride 0
    positive = target[:, None] == torch.arange(num_classes, device=target.device)
    return _binned_multi_threshold_confmat(
        preds.to(torch.float32).contiguous(), positive, valid[:, None].expand(-1, num_classes), sorted_thresholds
    )


def _multiclass_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_classes: int,
    thresholds: Optional[torch.Tensor],
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """Final per-class curves."""
    if isinstance(state, torch.Tensor):
        tps = state[:, :, 1, 1]
        fps = state[:, :, 0, 1]
        fns = state[:, :, 1, 0]
        precision = _safe_divide(tps, tps + fps)
        recall = _safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros((1, num_classes), dtype=recall.dtype, device=recall.device)])
        return precision.T, recall.T, thresholds

    precision, recall, thresh = [], [], []
    for i in range(num_classes):
        res = _binary_precision_recall_curve_compute((state[0][:, i], state[1]), None, pos_label=i)
        precision.append(res[0])
        recall.append(res[1])
        thresh.append(res[2])
    return precision, recall, thresh


def multiclass_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """PR curves for multiclass tasks."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)


# --------------------------------------------------------------------------- multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: torch.Tensor, target: torch.Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    if preds.shape[1] != num_labels:
        raise ValueError(
            "Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )


def _multilabel_precision_recall_curve_format(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """To ``(samples, L)``; sigmoid unless every score lies in [0, 1]; ignored elements
    become ``-4 * L * T`` (``-4 * L`` in exact mode) in both scores and targets."""
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target, 1, -1).reshape(-1, num_labels)
    if not _all_in_unit_interval(preds):
        preds = _sigmoid(preds)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if ignore_index is not None:
        idx = target == ignore_index
        sentinel = -4 * num_labels * (thresholds.shape[0] if thresholds is not None else 1)
        preds = torch.where(idx, sentinel, preds)
        target = torch.where(idx, sentinel, target)
    return preds, target, thresholds


def _multilabel_precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    sorted_thresholds: Optional[SortedThresholds] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Binned: ``(T, L, 2, 2)`` via K2 with a per-element valid mask; exact: the scores
    and targets themselves."""
    if thresholds is None:
        return preds, target
    if sorted_thresholds is None:
        sorted_thresholds = sort_thresholds(thresholds)
    return _binned_multi_threshold_confmat(
        preds.to(torch.float32).contiguous(), target > 0, target >= 0, sorted_thresholds
    )


def _multilabel_exact_columns(
    state: Tuple[torch.Tensor, torch.Tensor], num_labels: int, ignore_index: Optional[int]
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per label, the exact-mode scores and targets without the ``ignore_index`` ones
    (the negative sentinel ones are dropped by the binary compute after it)."""
    columns = []
    for i in range(num_labels):
        preds_i, target_i = state[0][:, i], state[1][:, i]
        if ignore_index is not None:
            keep = target_i != ignore_index
            preds_i, target_i = preds_i[keep], target_i[keep]
        columns.append((preds_i, target_i))
    return columns


def _multilabel_precision_recall_curve_compute(
    state: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]],
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int] = None,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """Final per-label curves."""
    if isinstance(state, torch.Tensor):
        return _multiclass_precision_recall_curve_compute(state, num_labels, thresholds)
    precision, recall, thresh = [], [], []
    for column in _multilabel_exact_columns(state, num_labels, ignore_index):
        res = _binary_precision_recall_curve_compute(column, None, pos_label=1)
        precision.append(res[0])
        recall.append(res[1])
        thresh.append(res[2])
    return precision, recall, thresh


def multilabel_precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List, List, List]]:
    """PR curves for multilabel tasks."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task router for the PR curve."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args),
        lambda c: multiclass_precision_recall_curve(preds, target, c, thresholds, ignore_index, validate_args),
        lambda n: multilabel_precision_recall_curve(preds, target, n, thresholds, ignore_index, validate_args),
    )
