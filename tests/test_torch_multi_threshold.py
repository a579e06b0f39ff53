"""K2 (multi-threshold counts): the port's plain version against the JAX package.

The same seeded numpy inputs go through ``torchmetrics_tpu_torch.ops.multi_threshold``
on the CPU (its plain version) and through the JAX package's Pallas kernel in
interpret mode and its histogram route. Counts are integers and must agree exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops.multi_threshold import _counts_histogram, _counts_pallas
from torchmetrics_tpu.functional.classification.precision_recall_curve import _binned_multi_threshold_confmat
from torchmetrics_tpu_torch.ops.multi_threshold import (
    _multi_threshold_confmat_plain,
    multi_threshold_confmat,
    multi_threshold_counts,
    sort_thresholds,
)


def _inputs(n: int, c: int, t: int, seed: int, sorted_thr: bool = False):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(0, 1, (n, c)).astype(np.float32)
    preds[rng.random((n, c)) < 0.05] = np.nan
    positive = (rng.random((n, c)) < 0.4).astype(np.int32)
    valid = rng.random((n, c)) < 0.9
    thr = rng.uniform(0, 1, t).astype(np.float32)
    thr[1] = thr[0]  # duplicated threshold
    if sorted_thr:
        thr = np.sort(thr)
    if n:
        preds[0, 0] = thr[2]  # a score exactly on a threshold
    return preds, positive, valid, thr


def _port(preds, positive, valid, thr):
    return multi_threshold_counts(
        torch.from_numpy(preds), torch.from_numpy(positive), torch.from_numpy(valid), *sort_thresholds(torch.from_numpy(thr))
    )


def _check(got, preds, positive, valid, thr):
    args = tuple(jnp.asarray(x) for x in (preds, positive, valid, thr))
    for want in (_counts_pallas(*args, interpret=True), _counts_histogram(*args)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]), err_msg="tp")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]), err_msg="predpos")
    both = (np.asarray(positive) != 0) & np.asarray(valid)
    np.testing.assert_array_equal(got[2].numpy(), both.sum(0), err_msg="pos_total")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(valid).sum(0), err_msg="tot_total")
    assert all(x.dtype == torch.int32 for x in got)


@pytest.mark.parametrize(("n", "c", "t"), [(300, 1, 17), (300, 3, 17), (257, 10, 33)])
@pytest.mark.parametrize("sorted_thr", [False, True])
def test_plain_matches_jax(n, c, t, sorted_thr):
    preds, positive, valid, thr = _inputs(n, c, t, seed=n + c + t, sorted_thr=sorted_thr)
    _check(_port(preds, positive, valid, thr), preds, positive, valid, thr)


def test_all_invalid_batch_counts_nothing():
    preds, positive, _, thr = _inputs(64, 4, 9, seed=1)
    valid = np.zeros_like(positive, dtype=bool)
    got = _port(preds, positive, valid, thr)
    _check(got, preds, positive, valid, thr)
    assert all(int(x.abs().sum()) == 0 for x in got)


def test_empty_batch():
    preds, positive, valid, thr = _inputs(0, 4, 9, seed=2)
    got = _port(preds, positive, valid, thr)
    assert got[0].shape == (9, 4) and got[2].shape == (4,)
    _check(got, preds, positive, valid, thr)


def test_one_hot_and_broadcast_inputs_of_the_curve_update():
    """The inputs ``_multiclass_precision_recall_curve_update`` builds: a one-hot of the
    targets and the row mask broadcast over the classes (stride 0, not copied)."""
    rng = np.random.default_rng(7)
    n, c, t = 200, 5, 21
    preds = rng.uniform(0, 1, (n, c)).astype(np.float32)
    target = rng.integers(0, c, n)
    target[rng.random(n) < 0.1] = -1
    thr = np.linspace(0, 1, t).astype(np.float32)[rng.permutation(t)]
    valid_rows = torch.from_numpy(target >= 0)
    safe = torch.from_numpy(np.where(target >= 0, target, 0))
    valid = valid_rows[:, None].expand(-1, c)
    assert valid.stride() == (1, 0)
    positive_np = np.eye(c, dtype=np.int32)[np.where(target >= 0, target, 0)]
    valid_np = np.broadcast_to((target >= 0)[:, None], (n, c))
    for positive in (torch.nn.functional.one_hot(safe, c), safe[:, None] == torch.arange(c)):
        got = multi_threshold_counts(torch.from_numpy(preds), positive, valid, *sort_thresholds(torch.from_numpy(thr)))
        _check(got, preds, positive_np, valid_np, thr)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    preds, positive, valid, thr = (torch.from_numpy(x) for x in _inputs(8, 2, 5, seed=3))
    sorted_thr = sort_thresholds(thr)
    with pytest.raises(TypeError, match="float32"):
        multi_threshold_counts(preds.double(), positive, valid, *sorted_thr)
    with pytest.raises(ValueError, match="must match"):
        multi_threshold_counts(preds, positive[:4], valid, *sorted_thr)
    with pytest.raises(TypeError, match="bool, uint8"):
        multi_threshold_counts(preds, positive.float(), valid, *sorted_thr)
    with pytest.raises(TypeError, match="sort_thresholds"):
        multi_threshold_counts(preds, positive, valid, sorted_thr[0], sorted_thr[1].int())


def _confmat_case(kind: str, seed: int):
    """Inputs that stress the binning: crowded, tied or on-threshold scores, and
    duplicated, NaN or unsorted thresholds."""
    rng = np.random.default_rng(seed)
    n, c, t = 257, 4, 23
    thr = rng.uniform(0, 1, t).astype(np.float32)  # unsorted
    logits = rng.standard_normal((n, c)).astype(np.float32)
    preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    if kind == "peaked":  # a trained classifier: most scores near 0 or 1
        e = np.exp(8 * logits - (8 * logits).max(1, keepdims=True))
        preds = (e / e.sum(1, keepdims=True)).astype(np.float32)
    elif kind == "all_equal":
        preds = np.full((n, c), thr[5], np.float32)
    elif kind == "on_threshold":
        preds = thr[rng.integers(0, t, (n, c))]
    elif kind == "duplicated_thresholds":
        thr[rng.integers(0, t, 10)] = thr[0]
        preds[:, 0] = thr[0]
    elif kind == "nan_thresholds":
        thr[[2, 9]] = np.nan
        preds[rng.random((n, c)) < 0.1] = np.nan
    elif kind == "empty":
        preds = preds[:0]
    positive = np.eye(c, dtype=np.int32)[rng.integers(0, c, preds.shape[0])]
    valid = np.broadcast_to((rng.random(preds.shape[0]) < 0.9)[:, None], preds.shape).copy()
    if kind == "all_invalid":
        valid[:] = False
    return preds, positive, valid, thr


_CONFMAT_CASES = [
    "peaked", "all_equal", "on_threshold", "duplicated_thresholds", "nan_thresholds", "all_invalid", "empty",
]


@pytest.mark.parametrize("kind", _CONFMAT_CASES)
def test_confmat_plain_matches_jax(kind):
    """The plain confusion tensor against the JAX package's, and the counts read out of
    it against the Pallas kernel (interpret mode) and the histogram route."""
    preds, positive, valid, thr = _confmat_case(kind, seed=len(kind))
    args = (
        torch.from_numpy(preds), torch.from_numpy(positive), torch.from_numpy(valid),
        *sort_thresholds(torch.from_numpy(thr)),
    )
    got = multi_threshold_confmat(*args)
    assert got.dtype == torch.int32 and got.shape == (thr.shape[0], preds.shape[1], 2, 2)
    assert torch.equal(got, _multi_threshold_confmat_plain(*args))
    want = _binned_multi_threshold_confmat(*(jnp.asarray(x) for x in (preds, positive, valid, thr)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check(_port(preds, positive, valid, thr), preds, positive, valid, thr)


def test_counts_need_a_threshold():
    preds, positive, valid, _ = (torch.from_numpy(x) for x in _inputs(8, 2, 5, seed=4))
    empty = sort_thresholds(torch.zeros(0))
    assert multi_threshold_confmat(preds, positive, valid, *empty).shape == (0, 2, 2, 2)
    with pytest.raises(ValueError, match="at least one threshold"):
        multi_threshold_counts(preds, positive, valid, *empty)


@pytest.mark.parametrize(
    ("n", "c", "t"),
    [(8192, 10, 200), (8192, 1000, 200), (8229, 1000, 200), (1000, 3, 17), (777, 1, 5), (512, 3, 40000)],
)
def test_launch_plan_covers_the_problem_and_fits_the_card(n, c, t):
    """The plan the wrapper caches for the kernel, for an H100 (132 SMs, 227 KB of
    shared memory a block may opt in to): every row and class is covered, the shared
    memory fits, and the grid fills the card where the work allows."""
    from torchmetrics_tpu_torch.ops.multi_threshold import _STATIC_SMEM, _THREADS, _make_plan

    sms, max_smem = 132, 232448 - _STATIC_SMEM
    plan = _make_plan(n, c, t, sms, max_smem)
    tw = 1 << plan.tw_log
    tiles = -(-c // tw)
    assert plan.rows_per_chunk * plan.row_chunks >= n > plan.rows_per_chunk * (plan.row_chunks - 1)
    assert tw <= max(c, 1) and plan.smem_bytes <= max_smem
    assert plan.cells >= min(2 * t, 4096) and plan.cells & (plan.cells - 1) == 0
    assert plan.scratch_words * 8 >= c * (t + 1) * 8 + 4 * tiles
    if plan.smem:
        assert plan.smem_bytes == 8 * tw * (t + 1) + 4 * t + 4 * (plan.cells + 1)
    blocks = tiles * plan.row_chunks
    assert blocks >= min(sms, n * c // (2 * _THREADS)), plan
    assert plan.smem == (t < 20000)  # one class's packed histogram must fit
