"""Recall at a fixed precision for binary, multiclass and multilabel tasks, and the
task router (counterpart of
``torchmetrics_tpu/functional/classification/recall_fixed_precision.py``).

The states are the PR curve's: binned (kernel K2's ``(T, [C,] 2, 2)`` confusion
tensor) or exact. The choice of the operating point is a small host reduction over
the computed curve, in float64, as in the JAX package: among the points whose
constrained value clears the floor, the largest objective, ties broken by the
constrained value and then the threshold (the last index of a ``lexsort`` wins). It
gives ``(0.0, 1e6)`` when no point qualifies, and the threshold ``1e6`` when the best
objective is 0. The curve's float32 values meet a float64 floor, so a point that sits
on it (a precision of exactly 0.5) qualifies as it does in the JAX package only
because the binned curve is bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utilities.enums import _route_task

CurveState = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
OperatingPoint = Tuple[float, float]


def _host64(x: Union[torch.Tensor, np.ndarray]) -> np.ndarray:
    """``x`` as a float64 numpy array (a float32 value converts exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def _lexi_max_at_constraint(
    objective: np.ndarray, constrained: np.ndarray, thresholds: np.ndarray, min_constraint: float
) -> OperatingPoint:
    """The largest objective among the points whose constrained value clears the floor,
    and its threshold; ``(0.0, 1e6)`` when no point qualifies.

    The curves end in a point with no threshold; truncating to the shortest of the
    three drops it, as the reference's ``zip`` does.
    """
    obj, con, thr = _host64(objective), _host64(constrained), _host64(thresholds)
    n = min(len(obj), len(con), len(thr))
    obj, con, thr = obj[:n], con[:n], thr[:n]
    mask = con >= min_constraint
    if not mask.any():
        return 0.0, 1e6
    obj, con, thr = obj[mask], con[mask], thr[mask]
    best = np.lexsort((thr, con, obj))[-1]
    max_obj = float(obj[best])
    best_thr = float(thr[best]) if max_obj != 0.0 else 1e6
    return max_obj, best_thr


def _recall_at_precision(
    precision: np.ndarray, recall: np.ndarray, thresholds: np.ndarray, min_precision: float
) -> OperatingPoint:
    """Highest recall whose precision clears the floor."""
    return _lexi_max_at_constraint(recall, precision, thresholds, min_precision)


def _operating_points(points, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(value, threshold)`` as two float32 tensors on ``device``: 0-d for one point,
    ``(C,)`` for a sequence of per-class points."""
    values, thresholds = zip(*points) if isinstance(points, list) else points
    return (
        torch.tensor(values, dtype=torch.float32, device=device),
        torch.tensor(thresholds, dtype=torch.float32, device=device),
    )


def _per_class_points(
    first: Union[torch.Tensor, List[torch.Tensor]],
    second: Union[torch.Tensor, List[torch.Tensor]],
    thresholds: Union[torch.Tensor, List[torch.Tensor]],
    floor: float,
    reduce_fn: Callable,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``reduce_fn`` over each class's curve: ``(C, T)`` tensors fetched to the host in
    one go when binned, lists of per-class tensors when exact."""
    if isinstance(first, torch.Tensor):
        device = first.device
        first, second, thr = _host64(first), _host64(second), _host64(thresholds)
        points = [reduce_fn(a, b, thr, floor) for a, b in zip(first, second)]
    else:
        device = first[0].device
        points = [reduce_fn(a, b, t, floor) for a, b, t in zip(first, second, thresholds)]
    return _operating_points(points, device)


def _validate_fixed_point_arg(value: float, name: str) -> None:
    """The [0, 1] float check of the ``min_precision`` / ``min_recall`` /
    ``min_sensitivity`` floors."""
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Expected argument `{name}` to be an float in the [0,1] range, but got {value}")


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    arg_name: str = "min_precision",
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _validate_fixed_point_arg(min_precision, arg_name)


def _binary_recall_at_fixed_precision_compute(
    state: CurveState,
    thresholds: Optional[torch.Tensor],
    min_precision: float,
    pos_label: int = 1,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[torch.Tensor, torch.Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _operating_points(reduce_fn(precision, recall, thresholds, min_precision), precision.device)


def binary_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest recall given a minimum precision, binary task: ``(recall, threshold)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.classification import binary_recall_at_fixed_precision
        >>> preds = torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65])
        >>> target = torch.tensor([1, 0, 1, 1, 0, 0])
        >>> tuple(round(float(v), 4) for v in binary_recall_at_fixed_precision(preds, target, min_precision=0.5))
        (1.0, 0.35)
    """
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, thresholds)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    arg_name: str = "min_precision",
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _validate_fixed_point_arg(min_precision, arg_name)


def _multiclass_recall_at_fixed_precision_arg_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[torch.Tensor],
    min_precision: float,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[torch.Tensor, torch.Tensor]:
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_class_points(precision, recall, thresholds, min_precision, reduce_fn)


def multiclass_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-class recall given a minimum precision: ``(recalls, thresholds)``."""
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds)
    return _multiclass_recall_at_fixed_precision_arg_compute(state, num_classes, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    arg_name: str = "min_precision",
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _validate_fixed_point_arg(min_precision, arg_name)


def _multilabel_recall_at_fixed_precision_arg_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[torch.Tensor],
    ignore_index: Optional[int],
    min_precision: float,
    reduce_fn: Callable = _recall_at_precision,
) -> Tuple[torch.Tensor, torch.Tensor]:
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(
        state, num_labels, thresholds, ignore_index
    )
    return _per_class_points(precision, recall, thresholds, min_precision, reduce_fn)


def multilabel_recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Highest per-label recall given a minimum precision: ``(recalls, thresholds)``."""
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds)
    return _multilabel_recall_at_fixed_precision_arg_compute(state, num_labels, thresholds, ignore_index, min_precision)


def recall_at_fixed_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    task: str,
    min_precision: float,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task router for recall at a fixed precision."""
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_recall_at_fixed_precision(preds, target, min_precision, thresholds, ignore_index, validate_args),
        lambda c: multiclass_recall_at_fixed_precision(
            preds, target, c, min_precision, thresholds, ignore_index, validate_args
        ),
        lambda n: multilabel_recall_at_fixed_precision(
            preds, target, n, min_precision, thresholds, ignore_index, validate_args
        ),
    )
