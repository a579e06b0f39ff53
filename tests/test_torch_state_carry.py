"""State carried from the JAX package into the port with ``interop.state_from_jax``.

A JAX metric takes batches 0..k; its ``state_dict()`` loads into the port's metric,
which takes batches k+1..n. The port's ``compute()`` must equal the JAX metric's over
all batches, and the carried states must agree exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.interop import state_from_jax

C, T = 6, 15


def _batches(seed: int, n_batches: int = 5, batch: int = 48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        logits = rng.standard_normal((batch, C)).astype(np.float32)
        e = np.exp(logits - logits.max(1, keepdims=True))
        out.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, C, batch)))
    return out


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "atol"),
    [
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, dict(num_classes=C, average="weighted"), 1e-6),
        (tc.MulticlassAUROC, jc.MulticlassAUROC, dict(num_classes=C, thresholds=T), 1e-5),
        (tc.MulticlassAUROC, jc.MulticlassAUROC, dict(num_classes=C), 1e-5),
    ],
)
@pytest.mark.parametrize("k", [1, 3])
def test_carry_jax_state_into_the_port(port_cls, ref_cls, kwargs, atol, k):
    batches = _batches(seed=k)
    ref = ref_cls(**kwargs)
    ref.persistent(True)
    for preds, target in batches[:k]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))

    carried = state_from_jax(ref.state_dict(), "cpu")
    port = port_cls(**kwargs, device="cpu")
    port.load_state_dict(carried)
    assert port.update_count == k
    for attr in ref._defaults:
        value = getattr(port, attr)
        values = value if isinstance(value, list) else [value]
        assert all(v.dtype in (torch.int32, torch.float32) for v in values), attr

    for preds, target in batches[k:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), atol=atol, rtol=0)
    port.persistent(True)
    for key, value in port.state_dict().items():
        want = ref.state_dict()[key]
        if isinstance(value, list):
            np.testing.assert_array_equal(torch.cat(value).numpy(), np.concatenate(want))
        else:
            np.testing.assert_array_equal(np.asarray(value), np.asarray(want), err_msg=key)


def test_state_from_jax_refuses_counts_past_int32():
    with pytest.raises(ValueError, match="int32"):
        state_from_jax({"tp": np.array([2**31], dtype=np.int64)}, "cpu")
