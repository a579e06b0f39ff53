"""``RetrievalMetric``, the base of the query-grouped metrics (counterpart of
``torchmetrics_tpu/retrieval/base.py``).

``compute`` packs the epoch's flat ``(indexes, preds, target)`` rows into dense
``(num_queries, max_len)`` matrices, rows in ascending index order, columns in
descending score order (pads ``-inf`` / 0 / False), and every built-in metric is a
batched reduction over the last axis. The JAX package packs on the host with numpy;
here the pack runs on the metric's device and reads the host once per ``compute``, for
``(num_queries, max_len)``, which are shapes. A subclass that only overrides the
per-query ``_metric`` hook still works, through a loop over the rows.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, List, Optional, Tuple

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.checks import _check_retrieval_inputs
from torchmetrics_tpu_torch.utilities.data import _argsort_descending, dim_zero_cat


def _pack_query_groups(
    indexes: torch.Tensor, preds: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank-sorted dense ``(preds_mat, target_mat, valid)`` from flat grouped rows.

    The order is ``np.lexsort((-preds, indexes))``'s: a stable descending sort of the
    scores (NaN last), then a stable sort by index. Each row's query and rank come from
    the index changes along the sorted rows; one host read gives the matrices' shape.
    """
    n = indexes.shape[0]
    by_score = _argsort_descending(preds)
    order = by_score[torch.argsort(indexes[by_score], stable=True)]
    idx, p, t = indexes[order], preds[order], target[order]
    starts = torch.ones(n, dtype=torch.bool, device=idx.device)
    starts[1:] = idx[1:] != idx[:-1]
    rows = torch.cumsum(starts, dim=0) - 1
    positions = torch.arange(n, device=idx.device)
    ranks = positions - torch.cummax(torch.where(starts, positions, 0), dim=0).values
    n_queries, max_len = (int(v) for v in torch.stack([rows[-1] + 1, ranks.max() + 1]).tolist())

    flat = rows * max_len + ranks
    size = n_queries * max_len
    preds_mat = torch.full((size,), -torch.inf, dtype=torch.float32, device=idx.device).scatter_(0, flat, p)
    target_mat = torch.zeros(size, dtype=torch.float32, device=idx.device).scatter_(0, flat, t.to(torch.float32))
    valid = torch.zeros(size, dtype=torch.bool, device=idx.device).scatter_(0, flat, torch.ones_like(starts))
    shape = (n_queries, max_len)
    return preds_mat.view(shape), target_mat.view(shape), valid.view(shape)


class RetrievalMetric(Metric, ABC):
    """Query-grouped retrieval metric over float scores and binary relevance."""

    is_differentiable: bool = False
    higher_is_better: bool = True
    full_state_update: bool = False

    indexes: List[torch.Tensor]
    preds: List[torch.Tensor]
    target: List[torch.Tensor]

    # which side makes a query "empty": no positive target, or for fall-out no negative
    _empty_on_negatives: bool = False

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self.add_state("indexes", default=[], dist_reduce_fx=None)
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:
        """Check the shapes and types, flatten, and buffer the rows."""
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        indexes, preds, target = _check_retrieval_inputs(
            torch.as_tensor(indexes, device=self.device),
            torch.as_tensor(preds, device=self.device),
            torch.as_tensor(target, device=self.device),
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self.indexes.append(indexes)
        self.preds.append(preds)
        self.target.append(target)

    def _packed(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return _pack_query_groups(dim_zero_cat(self.indexes), dim_zero_cat(self.preds), dim_zero_cat(self.target))

    def compute(self) -> torch.Tensor:
        """Score every query and fold the scores by ``empty_target_action``."""
        preds_mat, target_mat, valid = self._packed()
        scores = self._metric_dense(preds_mat, target_mat, valid)

        if self._empty_on_negatives:
            empty = ((1 - target_mat) * valid).sum(dim=-1) == 0
        else:
            empty = target_mat.sum(dim=-1) == 0

        if self.empty_target_action == "error" and bool(empty.any()):
            side = "negative" if self._empty_on_negatives else "positive"
            raise ValueError(f"`compute` method was provided with a query with no {side} target.")
        if self.empty_target_action == "skip":
            kept = torch.where(~empty, scores, 0.0)
            n_kept = (~empty).sum()
            return torch.where(n_kept == 0, 0.0, kept.sum() / torch.where(n_kept == 0, 1, n_kept))
        fill = 1.0 if self.empty_target_action == "pos" else 0.0
        return torch.where(empty, fill, scores).mean()

    @staticmethod
    def _validate_top_k(top_k: Optional[int]) -> Optional[int]:
        """The ``top_k`` argument check of the @k subclasses."""
        if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
            raise ValueError("`top_k` has to be a positive integer or None")
        return top_k

    def _in_topk(self, valid: torch.Tensor) -> torch.Tensor:
        """Mask of the slots inside this metric's top-k cut (every valid slot when unset)."""
        top_k = getattr(self, "top_k", None)
        if top_k is None:
            return valid
        return valid & (torch.arange(valid.shape[-1], device=valid.device) < top_k)

    def _metric_dense(self, preds_mat: torch.Tensor, target_mat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """Per-query scores ``(num_queries,)`` over the rank-sorted rows.

        Built-ins override this. The default calls the per-query ``_metric`` hook of a
        user subclass row by row, reading each row's length on the host.
        """
        scores = []
        for row, n in enumerate(valid.sum(dim=-1).tolist()):
            target_row = target_mat[row, :n]
            if not self.allow_non_binary_target:
                # the pack holds float32; binary metrics get ints back, so a `_metric`
                # that calls a public functional passes its checks
                target_row = target_row.to(torch.int32)
            scores.append(torch.as_tensor(self._metric(preds_mat[row, :n], target_row), dtype=torch.float32))
        return torch.stack(scores) if scores else torch.zeros(0, device=preds_mat.device)

    def _metric(self, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Per-query metric over one rank-sorted row."""
        raise NotImplementedError

    def plot(self, val: Optional[Any] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


__all__ = ["RetrievalMetric", "_pack_query_groups"]
