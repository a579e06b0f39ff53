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
from torchmetrics_tpu_torch.ops.multi_threshold import multi_threshold_counts, sort_thresholds


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
