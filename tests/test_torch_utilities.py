"""The port's utilities against their JAX twins on the same seeded inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.utilities import compute as jcompute
from torchmetrics_tpu.utilities import data as jdata
from torchmetrics_tpu_torch.utilities import compute as tcompute
from torchmetrics_tpu_torch.utilities import data as tdata

rng = np.random.default_rng(0)
X = rng.standard_normal((6, 5)).astype(np.float32)
LABELS = rng.integers(0, 5, 12)


def _close(port, ref, atol=1e-6):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("name", ["dim_zero_sum", "dim_zero_mean", "dim_zero_max", "dim_zero_min"])
def test_dim_zero_reductions(name):
    _close(getattr(tdata, name)(torch.from_numpy(X)), getattr(jdata, name)(jnp.asarray(X)))


def test_dim_zero_cat_and_onehot_and_topk():
    parts = [X[0], X[1, :2], X[2, 0]]  # 0-d entries become length 1
    _close(tdata.dim_zero_cat([torch.from_numpy(np.asarray(p)) for p in parts]), jdata.dim_zero_cat([jnp.asarray(p) for p in parts]))
    _close(tdata.to_onehot(torch.from_numpy(LABELS), 5), jdata.to_onehot(jnp.asarray(LABELS), 5))
    for k in (1, 2, 3):
        _close(tdata.select_topk(torch.from_numpy(X), k), jdata.select_topk(jnp.asarray(X), k))


def test_bincount_drops_out_of_range():
    x = np.array([0, 2, 2, -1, 7, 4, 4, 4])
    got = tdata._bincount(torch.from_numpy(x), minlength=5)
    assert got.dtype == torch.int32
    _close(got, jdata._bincount(jnp.asarray(x), minlength=5))


def test_safe_math_and_auc():
    num, den = np.array([1, 0, 3, 4]), np.array([2, 0, 0, 8])
    _close(tcompute._safe_divide(torch.from_numpy(num), torch.from_numpy(den)), jcompute._safe_divide(jnp.asarray(num), jnp.asarray(den)))
    x = np.sort(rng.uniform(0, 1, (3, 9)).astype(np.float32), axis=1)
    y = rng.uniform(0, 1, (3, 9)).astype(np.float32)
    _close(
        tcompute._auc_compute_without_check(torch.from_numpy(x), torch.from_numpy(y), 1.0, axis=1),
        jcompute._auc_compute_without_check(jnp.asarray(x), jnp.asarray(y), 1.0, axis=1),
    )
    score = rng.uniform(0, 1, 5).astype(np.float32)
    tp, fp, fn = (rng.integers(0, 4, 5) for _ in range(3))
    tp[1] = fp[1] = fn[1] = 0
    for average in ("macro", "weighted", "none"):
        _close(
            tcompute._adjust_weights_safe_divide(torch.from_numpy(score), average, False, *(torch.from_numpy(v) for v in (tp, fp, fn))),
            jcompute._adjust_weights_safe_divide(jnp.asarray(score), average, False, *(jnp.asarray(v) for v in (tp, fp, fn))),
        )
