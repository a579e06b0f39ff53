"""Modular PR curves for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``).

Two state modes: ``thresholds=None`` keeps ``preds`` / ``target`` cat lists (exact
curve at compute time); ``thresholds`` given keeps a ``(T, [C,] 2, 2)`` sum-reduced
int32 confusion tensor (binned curve, counted by kernel K2). ROC, AUROC and average
precision subclass these and change only ``compute``.

Binned curves declare a reduction signature (their thresholds, ``ignore_index`` and
width), which the JAX package's do not: a ``MetricCollection`` then merges, say, a
binned AUROC and an average precision, or a multiclass AUROC and the fixed-point
metrics, over the same thresholds when it is built, and K2 runs once per update from
the first one, where the first-step value discovery would run it once per member at
that step. The groups are the ones that discovery finds.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.engine.statespec import update_family
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
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
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.multi_threshold import sort_thresholds
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import _route_task


class _CurveMetric(Metric):
    """The dual state of every curve metric, and the sorted thresholds K2 takes."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    preds: List[torch.Tensor]
    target: List[torch.Tensor]
    confmat: torch.Tensor

    def _init_curve_states(self, thresholds: Thresholds, width: Tuple[int, ...]) -> None:
        """Exact-mode cat lists, or a ``(T, *width, 2, 2)`` int32 confusion tensor."""
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._sorted_thresholds = None
            self.add_state("preds", default=[], dist_reduce_fx="cat")
            self.add_state("target", default=[], dist_reduce_fx="cat")
        else:
            # fixed for the metric's life: K2 takes them sorted, so sort once
            self._sorted_thresholds = sort_thresholds(self.thresholds)
            self.add_state(
                "confmat",
                default=torch.zeros((len(self.thresholds), *width, 2, 2), dtype=torch.int32),
                dist_reduce_fx="sum",
            )

    def _accumulate(self, state: Any) -> None:
        if isinstance(state, tuple):
            self.preds.append(state[0])
            self.target.append(state[1])
        else:
            self.confmat = self.confmat + state

    def _curve_state(self):
        return (dim_zero_cat(self.preds), dim_zero_cat(self.target)) if self.thresholds is None else self.confmat

    def _binned_signature(self, *knobs: Any) -> Optional[tuple]:
        """Reduction signature of a binned curve (``engine/statespec.py``): the update
        body, ``knobs`` and the threshold values (read once, when asked). Exact-mode
        cat lists do not fuse."""
        if self.thresholds is None:
            return None
        return (*update_family(self), *knobs, tuple(self.thresholds.tolist()), self.ignore_index)

    def to(self, device: Any) -> "_CurveMetric":  # type: ignore[override]
        super().to(device)
        if self.thresholds is not None:
            self.thresholds = self.thresholds.to(self.device)
            self._sorted_thresholds = sort_thresholds(self.thresholds)
        return self


class BinaryPrecisionRecallCurve(_CurveMetric):
    """PR curve for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(thresholds=5, device="cpu")
        >>> precision, recall, thresholds = metric(torch.tensor([0.0, 0.5, 0.7, 0.8]), torch.tensor([0, 1, 1, 0]))
        >>> [round(p, 4) for p in precision.tolist()], recall.tolist()
        ([0.5, 0.6667, 0.6667, 0.0, 0.0, 1.0], [1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    """

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_states(thresholds, ())

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch in the active state mode."""
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, _ = _binary_precision_recall_curve_format(preds, target, self.thresholds, self.ignore_index)
        self._accumulate(_binary_precision_recall_curve_update(preds, target, self.thresholds, self._sorted_thresholds))

    def _cse_signature(self) -> Optional[tuple]:
        return self._binned_signature()

    def compute(self):
        """Final (precision, recall, thresholds)."""
        return _binary_precision_recall_curve_compute(self._curve_state(), self.thresholds)


class MulticlassPrecisionRecallCurve(_CurveMetric):
    """PR curves for multiclass tasks."""

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_states(thresholds, (num_classes,))

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch in the active state mode."""
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, self.thresholds, self.ignore_index
        )
        self._accumulate(
            _multiclass_precision_recall_curve_update(
                preds, target, self.num_classes, self.thresholds, self._sorted_thresholds
            )
        )

    def _cse_signature(self) -> Optional[tuple]:
        return self._binned_signature(int(self.num_classes))

    def compute(self):
        """Final per-class (precision, recall, thresholds)."""
        return _multiclass_precision_recall_curve_compute(self._curve_state(), self.num_classes, self.thresholds)


class MultilabelPrecisionRecallCurve(_CurveMetric):
    """PR curves for multilabel tasks."""

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_states(thresholds, (num_labels,))

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch in the active state mode."""
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, self.thresholds, self.ignore_index
        )
        self._accumulate(
            _multilabel_precision_recall_curve_update(
                preds, target, self.num_labels, self.thresholds, self._sorted_thresholds
            )
        )

    def _cse_signature(self) -> Optional[tuple]:
        return self._binned_signature(int(self.num_labels))

    def compute(self):
        """Final per-label (precision, recall, thresholds)."""
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(), self.num_labels, self.thresholds, self.ignore_index
        )


class PrecisionRecallCurve:
    """Task router: returns the binary, multiclass or multilabel PR curve."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _route_task(
            task, num_classes, num_labels,
            lambda: BinaryPrecisionRecallCurve(**kwargs),
            lambda c: MulticlassPrecisionRecallCurve(c, **kwargs),
            lambda n: MultilabelPrecisionRecallCurve(n, **kwargs),
        )
