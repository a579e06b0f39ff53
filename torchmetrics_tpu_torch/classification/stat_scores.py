"""Modular stat scores for binary, multiclass and multilabel tasks, and the task router
(counterpart of ``torchmetrics_tpu/classification/stat_scores.py``).

Four sum-reduced int32 states for ``multidim_average="global"``, four cat lists for
``"samplewise"``. Under a state mesh the per-class counters are born sharded over the
class axis (``_engine_shard_rules``, ``parallel/sharding.py``): every rank computes the
batch's whole ``(C,)`` counts on its replicated batch (K1 unchanged) and adds the
block its shard owns.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.engine.statespec import update_family
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format_update,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
    _zero_rows_neutral,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.parallel.sharding import local_block
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.enums import _check_task_size, _route_task


class _AbstractStatScores(Metric):
    """Common tp/fp/tn/fn state plumbing."""

    tp: Any
    fp: Any
    tn: Any
    fn: Any

    # engine shape-bucketing opt-in (engine/bucketing.py): the "global" update is
    # additive over batch rows onto sum-reduced states, so pad rows subtract cleanly;
    # the samplewise cat lists are not sum-reduced, which the engine checks per state
    _engine_row_additive = True
    # placement (parallel/sharding.py): per-class counters split their class axis over
    # the state mesh; scalar micro counters and samplewise lists degrade to replication
    _engine_shard_rules = {"tp": "class_axis", "fp": "class_axis", "tn": "class_axis", "fn": "class_axis"}

    def _engine_pad_rows_neutral(self, inputs) -> bool:
        """Whether bucketing's zero pad rows count as they would alone (``engine/bucketing.py``)."""
        return _zero_rows_neutral(getattr(self, "threshold", None), inputs)

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        """Register the four counter states: tensors + sum for global, lists + cat for samplewise."""
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_state(self, tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> None:
        """Accumulate (add, or append for samplewise)."""
        if self.multidim_average == "samplewise":
            self.tp.append(tp)
            self.fp.append(fp)
            self.tn.append(tn)
            self.fn.append(fn)
        else:
            # a sharded counter adds the block of the batch's counts its rows own
            self.tp = self.tp + local_block(self, "tp", tp)
            self.fp = self.fp + local_block(self, "fp", fp)
            self.tn = self.tn + local_block(self, "tn", tn)
            self.fn = self.fn + local_block(self, "fn", fn)

    def _final_state(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate list states."""
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)

    def _update_family(self) -> tuple:
        """Identity of the state-producing update body for the CSE signature (the one
        shared keying rule, ``engine/statespec.update_family``)."""
        return update_family(self)


class BinaryStatScores(_AbstractStatScores):
    """tp/fp/tn/fn for binary tasks.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
        >>> metric = BinaryStatScores(device="cpu")
        >>> metric.update(torch.tensor([0.75, 0.05, 0.35, 0.75, 0.05, 0.65]), torch.tensor([1, 0, 1, 1, 0, 0]))
        >>> metric.compute().tolist()
        [2, 1, 2, 1, 3]
    """

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)
        preds, target = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self._update_state(*_binary_stat_scores_update(preds, target, self.multidim_average))

    def _cse_signature(self) -> Optional[tuple]:
        """Reduction signature (``engine/statespec.py``): every member of the binary
        family with the same threshold and ``ignore_index`` accumulates the same four
        counters; they differ only in ``compute``. Samplewise cat lists do not fuse."""
        if self.multidim_average != "global":
            return None
        return (*self._update_family(), float(self.threshold), self.ignore_index)

    def compute(self) -> torch.Tensor:
        """Final [tp, fp, tn, fn, support]."""
        tp, fp, tn, fn = self._final_state()
        return _binary_stat_scores_compute(tp, fp, tn, fn, self.multidim_average)


class MulticlassStatScores(_AbstractStatScores):
    """tp/fp/tn/fn for multiclass tasks."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(
            size=1 if (average == "micro" and top_k == 1) else num_classes, multidim_average=multidim_average
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index
            )
        tp, fp, tn, fn = _multiclass_stat_scores_format_update(
            preds, target, self.num_classes, self.top_k, self.average, self.multidim_average, self.ignore_index
        )
        self._update_state(tp, fp, tn, fn)

    def _cse_signature(self) -> Optional[tuple]:
        """Reduction signature (``engine/statespec.py``).

        ``average`` reaches the update only as the micro-with-top-1 collapse (scalar
        counters instead of per-class ones): macro, weighted and none accumulate the
        same per-class counts and differ only in ``compute``, so they share one
        ``"per-class"`` token and fuse. ``num_classes``, ``top_k`` and
        ``ignore_index`` shape the reduction and split the signature. Samplewise
        cat-list states do not fuse.
        """
        if self.multidim_average != "global":
            return None
        micro = self.average == "micro" and self.top_k == 1
        return (
            *self._update_family(),
            int(self.num_classes),
            int(self.top_k),
            "micro" if micro else "per-class",
            self.ignore_index,
        )

    def compute(self) -> torch.Tensor:
        """Final stat scores with averaging applied."""
        tp, fp, tn, fn = self._final_state()
        return _multiclass_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


class MultilabelStatScores(_AbstractStatScores):
    """tp/fp/tn/fn for multilabel tasks."""

    is_differentiable: bool = False
    higher_is_better: Optional[bool] = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        """Accumulate one batch."""
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )
        preds, target = _multilabel_stat_scores_format(
            preds, target, self.num_labels, self.threshold, self.ignore_index
        )
        self._update_state(*_multilabel_stat_scores_update(preds, target, self.multidim_average))

    def _cse_signature(self) -> Optional[tuple]:
        """Reduction signature (``engine/statespec.py``): the multilabel update never
        sees ``average`` (per-label counters for every mode), so the whole family fuses
        on matching ``num_labels``, threshold and ``ignore_index``."""
        if self.multidim_average != "global":
            return None
        return (*self._update_family(), int(self.num_labels), float(self.threshold), self.ignore_index)

    def compute(self) -> torch.Tensor:
        """Final stat scores with averaging applied."""
        tp, fp, tn, fn = self._final_state()
        return _multilabel_stat_scores_compute(tp, fp, tn, fn, self.average, self.multidim_average)


def _route_stat_scores(
    binary_cls: type,
    multiclass_cls: type,
    multilabel_cls: type,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    multidim_average: str,
    top_k: Optional[int],
    ignore_index: Optional[int],
    validate_args: bool,
    **kwargs: Any,
) -> Metric:
    """Shared task-router body of the stat-scores families; ``kwargs`` go to the class
    after the common ones (``beta=`` for F-beta, ``device=``, ...)."""
    kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
    return _route_task(
        task, num_classes, num_labels,
        lambda: binary_cls(threshold=threshold, **kwargs),
        lambda c: multiclass_cls(num_classes=c, top_k=_check_task_size("top_k", top_k), average=average, **kwargs),
        lambda n: multilabel_cls(num_labels=n, threshold=threshold, average=average, **kwargs),
    )


class StatScores(_AbstractStatScores):
    """Task router: ``StatScores(task=...)`` returns the binary, multiclass or multilabel variant."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> Metric:
        return _route_stat_scores(
            BinaryStatScores, MulticlassStatScores, MultilabelStatScores,
            task, threshold, num_classes, num_labels, average, multidim_average, top_k, ignore_index, validate_args,
            **kwargs,
        )
