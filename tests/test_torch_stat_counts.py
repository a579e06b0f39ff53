"""K1 (fused logits -> per-class stat counts): the port's plain version against the JAX package.

The same seeded numpy inputs go through ``torchmetrics_tpu_torch.ops.stat_counts`` on
the CPU (its plain version) and through the JAX package's Pallas kernel in interpret
mode and its one-hot-matmul route. Counts are integers and must agree exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops.stat_counts import _fused_counts_pallas, fused_multiclass_stat_scores
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    fused_multiclass_stat_scores as port_fused,
)
from torchmetrics_tpu_torch.ops.stat_counts import _stat_counts_plain, stat_counts

IGNORE = -100


def _inputs(n: int, c: int, seed: int):
    """Logits with tied, NaN, -inf and signed-zero rows; targets with ignored and
    out-of-range rows."""
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((n, c)).astype(np.float32)
    target = rng.integers(0, c, n)
    if n >= 16:
        preds[0] = 0.0
        preds[1, :] = -1.0
        preds[1, c // 2] = preds[1, c - 1] = 3.0
        preds[2, min(1, c - 1)] = np.nan
        preds[2, c - 1] = np.nan
        preds[3] = -np.inf
        preds[4] = -1.0
        preds[4, c - 1], preds[4, 0] = -0.0, 0.0
        preds[rng.random(n) < 0.05, rng.integers(0, c)] = np.nan
        target[5:8] = IGNORE
        target[8] = c
        target[9] = -3
    return preds, target


CASES = [(300, 1), (300, 7), (300, 130), (0, 7)]


@pytest.mark.parametrize(("n", "c"), CASES)
@pytest.mark.parametrize("ignore_index", [None, IGNORE])
def test_plain_matches_pallas_interpret(n, c, ignore_index):
    preds, target = _inputs(n, c, seed=n + c)
    jt = target if ignore_index is None else np.where(target == ignore_index, -1, target)
    want = _fused_counts_pallas(jnp.asarray(preds), jnp.asarray(jt, jnp.int32), c, interpret=True)
    got = stat_counts(torch.from_numpy(preds), torch.from_numpy(target), c, ignore_index)
    for g, w, name in zip(got, want, ("tp", "pred_count", "tgt_count")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize(("n", "c"), CASES)
@pytest.mark.parametrize("ignore_index", [None, IGNORE])
def test_fused_stat_scores_match_onehot_matmul(n, c, ignore_index):
    preds, target = _inputs(n, c, seed=2 * n + c)
    want = fused_multiclass_stat_scores(
        jnp.asarray(preds), jnp.asarray(target), c, ignore_index=ignore_index, impl="onehot_matmul"
    )
    got = port_fused(torch.from_numpy(preds), torch.from_numpy(target), c, ignore_index)
    for g, w, name in zip(got, want, ("tp", "fp", "tn", "fn")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float64])
def test_plain_reads_other_float_types(dtype):
    preds, target = _inputs(200, 9, seed=5)
    x = torch.from_numpy(preds).to(dtype)
    # the counts depend only on the argmax, which the f32 view of the same values keeps
    want = _stat_counts_plain(x.to(torch.float32), torch.from_numpy(target), 9)
    got = stat_counts(x, torch.from_numpy(target).to(torch.int32), 9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    preds = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape"):
        stat_counts(preds, torch.zeros(4, dtype=torch.long), 5)
    with pytest.raises(TypeError, match="int32 or int64"):
        stat_counts(preds, torch.zeros(4), 3)
    with pytest.raises(TypeError, match="float32"):
        stat_counts(preds.to(torch.int32), torch.zeros(4, dtype=torch.long), 3)
