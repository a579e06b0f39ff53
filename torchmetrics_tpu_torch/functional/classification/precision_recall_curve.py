"""Multiclass precision-recall curves, the base of the curve family (ROC, AUROC).

Counterpart of the multiclass part of
``torchmetrics_tpu/functional/classification/precision_recall_curve.py``. Two modes:

* binned (``thresholds`` given): the state is a fixed ``(T, C, 2, 2)`` confusion
  tensor per threshold, counted by kernel K2 (``ops/multi_threshold.py``);
* exact (``thresholds=None``): the scores and targets are kept, and the curve is a
  sort over all of them at compute time, in plain PyTorch.

Ignored targets become ``-1`` and are masked out.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.ops.multi_threshold import multi_threshold_confmat, sort_thresholds
from torchmetrics_tpu_torch.utilities.checks import _is_floating
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import _cumsum

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


def _binary_precision_recall_curve_compute(
    state: Tuple[torch.Tensor, torch.Tensor], pos_label: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact-mode curve of one class: drops ignored (-1) targets, sorts all scores."""
    preds, target = state
    keep = target >= 0
    preds, target = preds[keep], target[keep]
    fps, tps, thresh = _binary_clf_curve(preds, target, pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = torch.cat([precision.flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall.flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresh.flip(0)


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
    if not bool(((preds >= 0) & (preds <= 1)).all()):
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
        res = _binary_precision_recall_curve_compute((state[0][:, i], state[1]), pos_label=i)
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
