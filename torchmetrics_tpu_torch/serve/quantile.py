"""Mergeable KLL-style quantile sketch as a metric state (counterpart of
``torchmetrics_tpu/serve/quantile.py``).

- **Fixed-capacity compactor levels in one tensor.** The state is a ``(levels, k + 1)``
  float32 tensor: row ``i`` holds up to ``k`` items of weight ``2**i`` (``+inf`` pads
  the free slots; the last column is the row's live-item count).
- **The update on the card.** ``update()`` cuts the batch into sorted runs of ``k``
  (and one padded ragged run) and pushes each through the compaction cascade, fixed
  shapes throughout, so with the engine on the whole update is one graph. The JAX
  package folds the full runs with one ``lax.scan``; the port runs the same
  ``_merge2`` cascades in the same order in a Python loop, so the compactors are
  bit-equal. Each run costs ``levels`` cascade levels of about a dozen operations:
  eagerly that is many launches per update, captured once and replayed under the
  engine.
- **Deterministic compaction.** A full level sorts its items and promotes the
  odd-indexed half of the even prefix to the level above (weight doubles); an odd
  leftover stays. Weight is conserved exactly.
- **Mergeable.** :func:`kll_merge` folds stacked sketches pairwise through the same
  cascade, left to right: the ``dist_reduce_fx``, so the packed sync folds it through
  the ``custom`` role, and ``merge_state`` and the federation fold use it too.

Rank-error bound: ``|rank(estimate) - ceil(q * n)| <= 2 * n * (ceil(log2(n / k)) + 1) / k``
(:meth:`KLLSketch.rank_error_bound`).

A rider state bins every sample over ``diag/hist.py``'s geometric :data:`BOUNDS`
(sum-merged): :meth:`KLLSketch.coarse_quantile` answers with that scheme's ≤ 18.92 %
one-sided value error, the cheap cross-check of the KLL estimate.
"""

from __future__ import annotations

from math import ceil, log2
from typing import Any, Sequence

import numpy as np
import torch

from torchmetrics_tpu_torch.diag.hist import BOUNDS, GROWTH
from torchmetrics_tpu_torch.metric import Metric

__all__ = ["KLLSketch", "kll_merge"]

_N_BOUNDS = len(BOUNDS)


def _merge2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two ``(L, k + 1)`` compactor states through the cascade.

    Per level: the two rows and the carry from below (a sorted ``4k`` window, ``+inf``
    padding keeps every shape fixed); the combined run is kept when it fits in ``k``
    slots, else the odd-indexed half of the even prefix is promoted (weight doubles
    into the carry) and the odd leftover item stays.
    """
    L, k1 = a.shape
    k = k1 - 1
    inf_k = torch.full((k,), float("inf"), dtype=a.dtype, device=a.device)
    inf_2k = torch.full((2 * k,), float("inf"), dtype=a.dtype, device=a.device)
    odd_pos = torch.arange(2 * k, dtype=a.dtype, device=a.device) * 2.0 + 1.0
    carry_items = inf_2k
    carry_cnt = torch.zeros((), dtype=a.dtype, device=a.device)
    rows = []
    for i in range(L):
        combined = torch.sort(torch.cat([a[i, :k], b[i, :k], carry_items])).values
        total = a[i, k] + b[i, k] + carry_cnt
        fits = total <= k
        m2 = torch.floor(total * 0.5) * 2.0  # even prefix length
        leftover = total - m2  # 0.0 or 1.0
        promoted = torch.where(odd_pos < m2, combined[1::2], float("inf"))
        leftover_item = combined.index_select(0, torch.clamp(m2, 0, combined.shape[0] - 1).to(torch.int64).reshape(1))
        compact_row = torch.cat([torch.where(leftover > 0, leftover_item, float("inf")), inf_k[1:]])
        new_items = torch.where(fits, combined[:k], compact_row)
        new_cnt = torch.where(fits, total, leftover)
        rows.append(torch.cat([new_items, new_cnt.reshape(1)]))
        carry_items = torch.where(fits, inf_2k, promoted)
        carry_cnt = torch.where(fits, 0.0, m2 * 0.5)
    # the levels hold k * 2**(levels - 1) weight; a carry escaping the top would be the
    # only weight-losing path (a capacity bound checked at construction)
    return torch.stack(rows)


def kll_merge(stacked: torch.Tensor) -> torch.Tensor:
    """Fold stacked ``(M, L, k + 1)`` sketches left to right: the ``dist_reduce_fx``. A
    fixed member order gives a byte-stable merged sketch."""
    out = stacked[0]
    for i in range(1, stacked.shape[0]):
        out = _merge2(out, stacked[i])
    return out


def _wrap_run(run: torch.Tensor, cnt: torch.Tensor, levels: int, k: int) -> torch.Tensor:
    """Lift one sorted ``<= k`` run into a single-level compactor state."""
    state = torch.cat(
        [torch.full((levels, k), float("inf"), dtype=run.dtype, device=run.device),
         torch.zeros((levels, 1), dtype=run.dtype, device=run.device)],
        dim=1,
    )
    return torch.cat([torch.cat([run, cnt.reshape(1)]).unsqueeze(0), state[1:]])


def _scan_full_runs(state: torch.Tensor, runs: torch.Tensor, levels: int, k: int) -> torch.Tensor:
    """Fold ``(m, k)`` sorted full runs into ``state``, one cascade per run in order:
    the JAX package's ``lax.scan``, unrolled."""
    cnt = torch.full((), float(k), dtype=runs.dtype, device=runs.device)
    for j in range(runs.shape[0]):
        state = _merge2(state, _wrap_run(runs[j], cnt, levels, k))
    return state


def _sketch_quantile(state: torch.Tensor, q: float) -> torch.Tensor:
    """Weighted-rank quantile over the (item, ``2**level``) pairs: the smallest item
    whose cumulative weight reaches ``ceil(q * W)`` (``diag/hist.py``'s convention)."""
    L, k1 = state.shape
    k = k1 - 1
    items = state[:, :k].reshape(-1)
    level_w = torch.repeat_interleave(2.0 ** torch.arange(L, dtype=state.dtype, device=state.device), k, output_size=L * k)
    weights = torch.where(torch.isfinite(items), level_w, 0.0)
    order = torch.argsort(items, stable=True)
    sorted_items = items[order]
    cum_w = torch.cumsum(weights[order], dim=0)
    total = cum_w[-1]
    rank = torch.clamp(torch.ceil(q * total), min=1.0)
    rank = torch.minimum(rank, torch.clamp(total, min=1.0))
    pos = torch.searchsorted(cum_w, rank.reshape(1))
    return sorted_items[torch.clamp(pos, 0, sorted_items.shape[0] - 1)][0]


class KLLSketch(Metric):
    """Mergeable quantile sketch: KLL compactor levels as one state.

    Args:
        k: per-level compactor capacity (even int >= 8; larger = tighter rank-error
            bound, ``2 * n * (ceil(log2(n/k)) + 1) / k``).
        levels: compactor levels; capacity ``k * 2**(levels - 1)`` total weight.
        qs: the quantiles ``compute()`` returns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.serve import KLLSketch
        >>> sketch = KLLSketch(k=64, device="cpu")
        >>> sketch.update(torch.arange(1000.0))
        >>> p50, p99 = sketch.compute()
        >>> bool(abs(float(p50) - 500.0) < 150)
        True
    """

    full_state_update = True
    higher_is_better = None
    is_differentiable = False

    def __init__(self, k: int = 256, levels: int = 20, qs: Sequence[float] = (0.5, 0.99), **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(k, int) and k >= 8 and k % 2 == 0):
            raise ValueError(f"Expected argument `k` to be an even int >= 8 but got {k}")
        if not (isinstance(levels, int) and 4 <= levels <= 32):
            raise ValueError(f"Expected argument `levels` to be an int in [4, 32] but got {levels}")
        self.k = k
        self.levels = levels
        self.qs = tuple(float(q) for q in qs)
        if not all(0.0 < q <= 1.0 for q in self.qs):
            raise ValueError(f"Expected argument `qs` to hold floats in (0, 1] but got {qs}")
        default = torch.cat(
            [torch.full((levels, k), float("inf"), dtype=torch.float32), torch.zeros((levels, 1), dtype=torch.float32)],
            dim=1,
        )
        # items and counts are ONE state, so the callable fold merges them atomically on
        # every fold path (the packed plan's custom role, merge_state, the federation)
        self.add_state("compactors", default=default, dist_reduce_fx=kll_merge)
        self.add_state("geo_counts", default=torch.zeros((_N_BOUNDS + 1,), dtype=torch.float32), dist_reduce_fx="sum")
        self._geo_bounds = torch.tensor(BOUNDS, dtype=torch.float32, device=self.device)
        from torchmetrics_tpu_torch.serve import stats as _serve_stats

        _serve_stats.register_sketch(self)

    def to(self, device: Any) -> "KLLSketch":
        super().to(device)
        self._geo_bounds = self._geo_bounds.to(self.device)
        return self

    def update(self, values: Any) -> None:
        """Fold a batch of finite samples into the sketch."""
        v = torch.as_tensor(values, device=self.device).reshape(-1).to(torch.float32)
        state = self.compactors
        n = int(v.shape[0])
        full = n // self.k
        if full:
            runs = torch.sort(v[: full * self.k].reshape(full, self.k), dim=1).values
            state = _scan_full_runs(state, runs, self.levels, self.k)
        if n - full * self.k or not n:
            chunk = v[full * self.k :]
            cnt = torch.full((), float(chunk.shape[0]), dtype=torch.float32, device=v.device)
            run = torch.sort(torch.nn.functional.pad(chunk, (0, self.k - chunk.shape[0]), value=float("inf"))).values
            state = _merge2(state, _wrap_run(run, cnt, self.levels, self.k))
        self.compactors = state
        if n:
            idx = torch.searchsorted(self._geo_bounds, v)
            self.geo_counts = self.geo_counts.index_add(0, idx, torch.ones_like(v))

    def compute(self) -> torch.Tensor:
        """The configured quantiles, in ``qs`` order, as one tensor."""
        return torch.stack([_sketch_quantile(self.compactors, q) for q in self.qs])

    def quantile(self, q: float) -> torch.Tensor:
        """Point query: the ``q``-quantile estimate from the compactor levels."""
        return _sketch_quantile(self.compactors, float(q))

    def coarse_quantile(self, q: float) -> torch.Tensor:
        """The geometric-bucket estimate (``diag/hist.py`` semantics): the upper bound
        of the bucket holding the rank, within ``[exact, exact * GROWTH]`` for in-range
        positive samples; an overflow-bucket rank returns the top boundary."""
        cum = torch.cumsum(self.geo_counts, dim=0)
        total = cum[-1]
        rank = torch.minimum(torch.clamp(torch.ceil(q * total), min=1.0), torch.clamp(total, min=1.0))
        pos = torch.searchsorted(cum, rank.reshape(1))
        return self._geo_bounds[torch.clamp(pos, 0, _N_BOUNDS - 1)][0]

    def rank_error_bound(self, n: int) -> int:
        """The worst-case rank displacement after ``n`` samples (0 while nothing has
        compacted)."""
        n = int(n)
        if n <= self.k:
            return 0
        return ceil(2.0 * n * (ceil(log2(n / self.k)) + 1) / self.k)

    def growth_bound(self) -> float:
        """The coarse (geometric-bucket) one-sided relative value-error bound."""
        return GROWTH - 1.0

    def fill_ratio(self) -> float:
        """Fraction of occupied compactor slots: the scrape saturation gauge."""
        from torchmetrics_tpu_torch.serve.snapshot import read_host

        state = read_host(self, ("compactors",))["compactors"]
        return float(np.isfinite(state[:, : self.k]).mean())

    def total_weight(self) -> int:
        """Samples represented (weight is conserved by construction)."""
        from torchmetrics_tpu_torch.serve.snapshot import read_host

        state = read_host(self, ("compactors",))["compactors"]
        return int(round(float((state[:, self.k] * (2.0 ** np.arange(self.levels))).sum())))
