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


def _binary_multilabel_batches(seed: int, labels: int, n_batches: int = 5, batch: int = 48):
    """Probabilities (no sigmoid separates the packages) and 0/1 targets with 10 % at -1."""
    rng = np.random.default_rng(seed)
    shape = (batch, labels) if labels else (batch,)
    out = []
    for _ in range(n_batches):
        target = rng.integers(0, 2, shape)
        target[rng.random(shape) < 0.1] = -1
        out.append((rng.uniform(0, 1, shape).astype(np.float32), target))
    return out


@pytest.mark.parametrize(
    ("name", "kwargs", "atol"),
    [
        ("BinaryF1Score", dict(ignore_index=-1), 1e-6),
        ("BinaryConfusionMatrix", dict(ignore_index=-1), 0),
        ("BinaryAUROC", dict(ignore_index=-1), 1e-5),
        ("BinaryAveragePrecision", dict(thresholds=T, ignore_index=-1), 1e-5),
        ("MultilabelF1Score", dict(num_labels=4, ignore_index=-1, average="macro"), 1e-6),
        ("MultilabelConfusionMatrix", dict(num_labels=4, ignore_index=-1), 0),
        ("MultilabelAUROC", dict(num_labels=4, ignore_index=-1), 1e-5),
        ("MultilabelAveragePrecision", dict(num_labels=4, thresholds=T, ignore_index=-1), 1e-5),
    ],
)
def test_carry_binary_and_multilabel_state_into_the_port(name, kwargs, atol):
    """As above for the binary and multilabel classes, ``ignore_index`` on: the exact
    multilabel AUROC carries the ``-4 * L`` sentinel in its target list."""
    batches = _binary_multilabel_batches(seed=len(name), labels=kwargs.get("num_labels", 0))
    k = 2
    ref = getattr(jc, name)(**kwargs)
    ref.persistent(True)
    for preds, target in batches[:k]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    port = getattr(tc, name)(**kwargs, device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    for preds, target in batches[k:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), atol=atol, rtol=0)
    port.persistent(True)
    for key, value in port.state_dict().items():
        want = ref.state_dict()[key]
        got = torch.cat(value).numpy() if isinstance(value, list) else np.asarray(value)
        np.testing.assert_array_equal(got, np.concatenate(want) if isinstance(want, list) else np.asarray(want), err_msg=key)
