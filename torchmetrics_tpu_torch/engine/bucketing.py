"""Shape buckets for ragged batches (counterpart of ``torchmetrics_tpu/engine/bucketing.py``).

A stream of odd batch sizes would capture one CUDA graph per distinct size. Instead,
inputs pad up to the next power-of-two bucket, so the number of graphs is bounded by
``O(log2(max_batch))`` however ragged the stream is.

Correctness comes from the pad-subtract identity: for a metric whose every state is
sum-reduced and whose ``update`` is additive over batch rows
(``new = old + sum_r g(row_r)``), a pad row contributes a fixed, state-independent
delta ``g(pad_row)``. The step computes

    out      = update(state, padded_inputs)            # includes the pad rows
    pad_unit = update(zeros_like(state), one_pad_row)  # = g(pad_row)
    result   = out - n_pad * pad_unit

with ``n_pad`` a device scalar, so one graph serves every batch size in its bucket,
the exact fit (``n_pad = 0``) included. When every input is batched, ``pad_unit`` is a
constant computed once per signature; a 0-d input (FID's real / fake flag) feeds it, so
its graph recomputes it at every replay, and an exact fit then takes a graph of its own
shape, which has no unit to compute. Eligibility is explicit: the metric class
opts in with ``_engine_row_additive = True`` (the stat-scores family, the confusion
matrices), stamped on each state at registration (``engine/statespec.py``), AND every
state folds with ``sum``; anything else captures per exact shape.

The identity also needs a pad row to count the same inside the padded batch as alone.
An update that transforms its input by a decision over the whole batch breaks that:
the binary and multilabel families sigmoid a float batch iff any value lies outside
[0, 1], so inside a batch of logits a zero pad row becomes 0.5, a positive under a
threshold below 0.5, while alone it stays 0.0, a negative. Such a metric says for
which inputs its pad rows are neutral (``_engine_pad_rows_neutral(inputs)``); for the
others the batch captures per exact shape.

The padding itself is a copy into the signature's static input buffers with a zero
tail (``engine/compiled.py``), not a new tensor per step.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.engine import config, statespec


def next_bucket(n: int, min_bucket: Optional[int] = None) -> int:
    """Smallest power-of-two bucket holding ``n`` rows (floored at ``MIN_BUCKET``).

    Example:
        >>> from torchmetrics_tpu_torch.engine.bucketing import next_bucket
        >>> [next_bucket(n) for n in (1, 8, 9, 100)]
        [8, 8, 16, 128]
    """
    b = min_bucket if min_bucket is not None else config.MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def bucket_eligible(metric: Any) -> bool:
    """Whether ``metric`` supports the pad-subtract identity: every registered state is
    row-additive (``statespec.row_additive``) and folds with ``sum``."""
    reductions = getattr(metric, "_reductions", {})
    if not reductions:
        return False
    return all(
        statespec.row_additive(metric, attr) and statespec.state_fold(metric, attr)[0] == "sum" for attr in reductions
    )


def pad_rows_neutral(metric: Any, inputs: Sequence[torch.Tensor]) -> bool:
    """Whether zero pad rows count the same inside a padded batch of ``inputs`` as alone
    (the metric's ``_engine_pad_rows_neutral(inputs)``; yes when it has none)."""
    check = getattr(metric, "_engine_pad_rows_neutral", None)
    return check is None or bool(check(inputs))


def batch_size(args: Sequence[Any]) -> Optional[int]:
    """The shared leading-axis size of the inputs, or None when there isn't one."""
    sizes = {a.shape[0] for a in args if getattr(a, "ndim", 0) >= 1}
    if len(sizes) != 1:
        return None
    return sizes.pop()


def bucketed_shape(a: torch.Tensor, bucket: int) -> Tuple[int, ...]:
    """``a``'s shape with a batched leading axis grown to ``bucket`` rows."""
    if a.ndim >= 1:
        return (bucket, *a.shape[1:])
    return tuple(a.shape)


def pad_row_constants(args: Sequence[torch.Tensor]) -> Tuple[Optional[torch.Tensor], ...]:
    """One-row zero inputs matching ``args``' trailing shapes: the inputs from which a
    step derives the per-pad-row contribution.

    Zero rows are the universal pad: integer inputs land on class or label 0 and float
    inputs on 0.0, valid update inputs for the eligible families. Non-batched (0-d)
    inputs yield ``None``: their live value must feed the unit computation.
    """
    return tuple(
        torch.zeros((1, *a.shape[1:]), dtype=a.dtype, device=a.device) if a.ndim >= 1 else None for a in args
    )
