"""AUROC for binary, multiclass and multilabel tasks, and the task router (counterpart
of ``torchmetrics_tpu/functional/classification/auroc.py``).

The area under the ROC curve of the shared PR-curve states. Binary ``max_fpr`` takes
the McClish-corrected partial area; finding where the curve crosses ``max_fpr`` reads
one index back to the host, at compute time only, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utilities.compute import _auc_compute_without_check, _safe_divide
from torchmetrics_tpu_torch.utilities.data import _bincount
from torchmetrics_tpu_torch.utilities.enums import _route_task
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

CurveState = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _reduce_class_scores(res: torch.Tensor, average: Optional[str], weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Average per-class scores (AUROC or AP); NaN classes are left out of the average."""
    if average is None or average == "none":
        return res
    if bool(torch.isnan(res).any()):
        rank_zero_warn(
            f"Average precision score for one or more classes was `nan`. Ignoring these classes in {average}-average",
            UserWarning,
        )
    idx = ~torch.isnan(res)
    if average == "macro":
        return torch.where(idx, res, 0.0).sum() / idx.sum()
    if average == "weighted" and weights is not None:
        w = _safe_divide(torch.where(idx, weights, 0.0), torch.where(idx, weights, 0.0).sum())
        return (torch.where(idx, res, 0.0) * w).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _reduce_auroc(
    fpr: Union[torch.Tensor, List[torch.Tensor]],
    tpr: Union[torch.Tensor, List[torch.Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reduce per-class AUCs."""
    if isinstance(fpr, torch.Tensor):
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=1)
    else:
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
    return _reduce_class_scores(res, average, weights)


def _class_weights(state: CurveState, num_classes: int) -> torch.Tensor:
    """Positives per class, float32. Exact mode counts the targets, ignored (-1) ones in
    the dropped bin of ``_bincount`` (no boolean index, no host sync); binned mode reads
    tp + fn, which does not depend on the threshold, at the first one."""
    if isinstance(state, torch.Tensor):
        return state[0][:, 1, :].sum(-1).to(torch.float32)
    return _bincount(state[1], minlength=num_classes).to(torch.float32)


# ------------------------------------------------------------------------------ binary


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(
    state: CurveState, thresholds: Optional[torch.Tensor], max_fpr: Optional[float] = None, pos_label: int = 1
) -> torch.Tensor:
    """Area under the ROC curve; with ``max_fpr`` the McClish-corrected partial area."""
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None or max_fpr == 1:
        return _auc_compute_without_check(fpr, tpr, 1.0)

    max_area = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    stop = int(torch.searchsorted(fpr, max_area, right=True))
    # the JAX package's gather clamps an index past the end to the last element
    after = min(stop, fpr.shape[0] - 1)
    weight = (max_area - fpr[stop - 1]) / (fpr[after] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[after] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def binary_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AUROC for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_auroc
        >>> float(binary_auroc(torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34]), torch.tensor([0, 0, 1, 1, 1])))
        0.5
    """
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_auroc_compute(state, thresholds, max_fpr)


# --------------------------------------------------------------------------- multiclass


def _multiclass_auroc_arg_validation(
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    if average not in ("macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('macro', 'weighted', 'none', None) but got {average}"
        )


def _multiclass_auroc_compute(
    state: CurveState,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=_class_weights(state, num_classes))


def multiclass_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AUROC for multiclass tasks."""
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


# --------------------------------------------------------------------------- multilabel


def _multilabel_auroc_arg_validation(
    num_labels: int,
    average: Optional[str],
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None) but got {average}"
        )


def _multilabel_micro_state(state: CurveState, ignore_index: Optional[int]) -> CurveState:
    """The labels pooled into one binary state: binned confusion tensors summed over
    labels; exact scores and targets flattened, without the ``ignore_index`` ones."""
    if isinstance(state, torch.Tensor):
        return state.sum(1)
    preds, target = state[0].flatten(), state[1].flatten()
    if ignore_index is not None:
        keep = target != ignore_index
        preds, target = preds[keep], target[keep]
    return preds, target


def _multilabel_class_weights(state: CurveState) -> torch.Tensor:
    """Positives per label, float32 (binned: tp + fn at the first threshold)."""
    if isinstance(state, torch.Tensor):
        return state[0][:, 1, :].sum(-1).to(torch.float32)
    return (state[1] == 1).sum(0).to(torch.float32)


def _multilabel_auroc_compute(
    state: CurveState,
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    if average == "micro":
        return _binary_auroc_compute(_multilabel_micro_state(state, ignore_index), thresholds, max_fpr=None)
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_auroc(fpr, tpr, average, weights=_multilabel_class_weights(state))


def multilabel_auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """AUROC for multilabel tasks."""
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> torch.Tensor:
    """Task router for AUROC."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args),
        lambda c: multiclass_auroc(preds, target, c, average, thresholds, ignore_index, validate_args),
        lambda n: multilabel_auroc(preds, target, n, average, thresholds, ignore_index, validate_args),
    )
