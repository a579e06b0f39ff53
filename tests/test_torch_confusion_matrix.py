"""MulticlassConfusionMatrix: the port (on the CPU) against the JAX package.

The same seeded numpy batches go through both packages at the three protocol levels
of ``tests/differential/harness.py``: the per-batch ``forward`` value, the fold of two
replicas via ``merge_state``, and the epoch ``compute``. Counts agree exactly;
normalized matrices to 1e-6 (both divide the same int32 counts in float32). Inputs
cover logits (with tied and NaN rows) and labels, every ``normalize``, ``ignore_index``
off, outside the classes and on a class, and out-of-range labels with
``validate_args=False``, which both packages drop.
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
from torchmetrics_tpu import MetricCollection as JaxMetricCollection
import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.classification as tf
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.interop import collection_state_from_jax, state_from_jax

N_BATCHES = 4
NORM_ATOL = 1e-6


def _batches(seed: int, c: int, n: int, kind: str, ignore_index=None, out_of_range: bool = False):
    """Seeded batches; class ``c - 1`` never occurs, so its row and column stay empty
    (the NaN that normalization turns into 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES):
        target = rng.integers(0, c - 1, n)
        if kind == "logits":
            preds = rng.standard_normal((n, c)).astype(np.float32)
            preds[:, c - 1] = -np.inf  # never the argmax
            preds[0, :] = 0.0  # all tied: index 0
            preds[1, 0] = preds[1, 1] = 9.0  # two maxima: the first wins
            preds[2, 1] = np.nan  # NaN is maximal
        else:
            preds = rng.integers(0, c - 1, n)
        if ignore_index is not None:
            target[rng.random(n) < 0.15] = ignore_index
        if out_of_range:
            target[3:6] = [-3, c, c + 2]
            if kind == "labels":
                preds[6:8] = [-1, c]
        out.append((preds, target))
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, normalize):
    if normalize in (None, "none"):
        np.testing.assert_array_equal(_np(port), np.asarray(ref))
    else:
        np.testing.assert_allclose(_np(port), np.asarray(ref), atol=NORM_ATOL, rtol=0)


def _warnings_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = fn()
    return value, sorted(str(w.message) for w in caught if "NaN values" in str(w.message))


CASES = [
    # (C, N, kind, ignore_index, out_of_range, validate_args)
    (5, 64, "logits", None, False, True),
    (10, 256, "logits", -100, False, True),
    (3, 128, "labels", None, False, True),
    (6, 96, "labels", 1, False, True),
    (7, 160, "labels", None, True, False),
    (4, 200, "logits", -100, True, False),
]


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize(("c", "n", "kind", "ignore_index", "out_of_range", "validate_args"), CASES)
def test_multiclass_confusion_matrix_three_levels(c, n, kind, ignore_index, out_of_range, validate_args, normalize):
    kwargs = dict(num_classes=c, ignore_index=ignore_index, normalize=normalize, validate_args=validate_args)
    batches = _batches(seed=c * 7 + n, c=c, n=n, kind=kind, ignore_index=ignore_index, out_of_range=out_of_range)

    # (a) per-batch forward values, with the same NaN warnings; (c) epoch compute
    port, ref = tc.MulticlassConfusionMatrix(**kwargs, device="cpu"), jc.MulticlassConfusionMatrix(**kwargs)
    for preds, target in batches:
        got, got_warn = _warnings_of(lambda: port(torch.from_numpy(preds), torch.from_numpy(target)))
        want, want_warn = _warnings_of(lambda: ref(jnp.asarray(preds), jnp.asarray(target)))
        _close(got, want, normalize)
        assert got_warn == want_warn
    assert port.confmat.dtype == torch.int32
    np.testing.assert_array_equal(_np(port.confmat), np.asarray(ref.confmat))
    epoch, epoch_warn = _warnings_of(ref.compute)
    got, got_warn = _warnings_of(port.compute)
    _close(got, epoch, normalize)
    assert got_warn == epoch_warn
    if normalize in ("true", "pred"):
        assert got_warn, "the empty class must produce the NaN warning"

    # (b) two replicas, each with half of the batches, folded with merge_state
    pa, pb = tc.MulticlassConfusionMatrix(**kwargs, device="cpu"), tc.MulticlassConfusionMatrix(**kwargs, device="cpu")
    ra, rb = jc.MulticlassConfusionMatrix(**kwargs), jc.MulticlassConfusionMatrix(**kwargs)
    for i, (preds, target) in enumerate(batches):
        first = i < len(batches) // 2
        (pa if first else pb).update(torch.from_numpy(preds), torch.from_numpy(target))
        (ra if first else rb).update(jnp.asarray(preds), jnp.asarray(target))
    pa.merge_state(pb)
    ra.merge_state(rb)
    np.testing.assert_array_equal(_np(pa.confmat), np.asarray(ra.confmat))
    assert pa.update_count == ra.update_count == N_BATCHES
    _close(pa.compute(), epoch, normalize)

    # the functional form over one batch
    preds, target = batches[0]
    _close(
        tf.multiclass_confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
        jf.multiclass_confusion_matrix(jnp.asarray(preds), jnp.asarray(target), **kwargs),
        normalize,
    )


def test_out_of_range_labels_are_dropped():
    """With ``validate_args=False`` a row whose target or prediction lies outside the
    classes counts nowhere; the rest count as usual."""
    preds = torch.tensor([0, 1, 2, -1, 3, 1])
    target = torch.tensor([0, 1, 2, 1, 1, -5])
    got = tf.multiclass_confusion_matrix(preds, target, num_classes=3, validate_args=False)
    assert got.tolist() == [[1, 0, 0], [0, 1, 0], [0, 0, 1]]


def test_invalid_arguments_raise_as_in_jax():
    for kwargs in (dict(num_classes=1), dict(num_classes=3, normalize="rows"), dict(num_classes=3, ignore_index=0.5)):
        with pytest.raises(ValueError) as port_err:
            tc.MulticlassConfusionMatrix(**kwargs, device="cpu")
        with pytest.raises(ValueError) as ref_err:
            jc.MulticlassConfusionMatrix(**kwargs)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("k", [1, 3])
def test_carry_jax_confusion_matrix_state_into_the_port(k):
    """A JAX matrix takes batches 0..k-1; its state (alone, and inside a collection)
    loads into the port, which takes the rest; both end equal to the JAX metric."""
    c = 6
    batches = _batches(seed=k, c=c, n=80, kind="logits")
    ref = jc.MulticlassConfusionMatrix(num_classes=c, normalize="true")
    ref_mc = JaxMetricCollection({"cm": jc.MulticlassConfusionMatrix(num_classes=c)})
    ref.persistent(True)
    ref_mc.persistent(True)
    for preds, target in batches[:k]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        ref_mc.update(jnp.asarray(preds), jnp.asarray(target))

    port = tc.MulticlassConfusionMatrix(num_classes=c, normalize="true", device="cpu")
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    port_mc = MetricCollection({"cm": tc.MulticlassConfusionMatrix(num_classes=c, device="cpu")})
    port_mc.load_state_dict(collection_state_from_jax(ref_mc.state_dict(), "cpu"))
    assert port.update_count == port_mc["cm"].update_count == k
    assert port_mc["cm"].confmat.dtype == torch.int32

    for preds, target in batches[k:]:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        ref_mc.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        port_mc.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(_np(port.confmat), np.asarray(ref.confmat))
    np.testing.assert_allclose(_np(port.compute()), np.asarray(ref.compute()), atol=NORM_ATOL, rtol=0)
    np.testing.assert_array_equal(_np(port_mc.compute()["cm"]), np.asarray(ref_mc.compute()["cm"]))
