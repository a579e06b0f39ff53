"""Modular multiclass stat scores (counterpart of ``torchmetrics_tpu/classification/stat_scores.py``).

Four sum-reduced int32 states for ``multidim_average="global"``, four cat lists for
``"samplewise"``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from torchmetrics_tpu_torch.engine.statespec import update_family
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format_update,
    _multiclass_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _AbstractStatScores(Metric):
    """Common tp/fp/tn/fn state plumbing."""

    tp: Any
    fp: Any
    tn: Any
    fn: Any

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
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn

    def _final_state(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenate list states."""
        return dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.tn), dim_zero_cat(self.fn)

    def _update_family(self) -> tuple:
        """Identity of the state-producing update body for the CSE signature (the one
        shared keying rule, ``engine/statespec.update_family``)."""
        return update_family(self)


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
