"""MulticlassAccuracy and MulticlassAUROC: the port (on the CPU) against the JAX package.

The same seeded numpy batches go through both packages at the three protocol levels
of ``tests/differential/harness.py``: the per-batch ``forward`` value, the fold of two
replicas via ``merge_state``, and the epoch ``compute``. Integer states agree exactly.
Accuracy values agree to 1e-6 (both divide identical int32 counts in float32); AUROC
values to 1e-5 (the trapezoid sums are taken in another order, and JAX's 64-bit mode
computes the exact curve in float64).
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

N_BATCHES, BATCH, C, T = 4, 64, 5, 11
ACC_ATOL, AUROC_ATOL = 1e-6, 1e-5


def _batches(seed: int, ignore_index=None, probs: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_BATCHES):
        logits = rng.standard_normal((BATCH, C)).astype(np.float32)
        if probs:
            e = np.exp(logits - logits.max(1, keepdims=True))
            logits = (e / e.sum(1, keepdims=True)).astype(np.float32)
        target = rng.integers(0, C, BATCH)
        if ignore_index is not None:
            target[rng.random(BATCH) < 0.15] = ignore_index
        out.append((logits, target))
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states_equal(port, ref):
    for attr in ref._defaults:
        p, r = getattr(port, attr), getattr(ref, attr)
        if isinstance(r, list):
            np.testing.assert_array_equal(_np(torch.cat(p)), np.concatenate([np.asarray(x) for x in r]), err_msg=attr)
        else:
            assert p.dtype in (torch.int32, torch.float32), attr
            np.testing.assert_array_equal(_np(p), np.asarray(r), err_msg=attr)


def _three_levels(make_port, make_ref, batches, atol, rtol=0.0):
    # (a) per-batch forward values, (c) epoch compute
    port, ref = make_port(), make_ref()
    for preds, target in batches:
        np.testing.assert_allclose(
            _np(port(torch.from_numpy(preds), torch.from_numpy(target))),
            np.asarray(ref(jnp.asarray(preds), jnp.asarray(target))),
            atol=atol, rtol=rtol,
        )
    _states_equal(port, ref)
    epoch = np.asarray(ref.compute())
    np.testing.assert_allclose(_np(port.compute()), epoch, atol=atol, rtol=rtol)

    # (b) two replicas, each with half of the batches, folded with merge_state (in
    # batch order, so cat-list states line up with the single instance's)
    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, (preds, target) in enumerate(batches):
        first = i < len(batches) // 2
        (pa if first else pb).update(torch.from_numpy(preds), torch.from_numpy(target))
        (ra if first else rb).update(jnp.asarray(preds), jnp.asarray(target))
    pa.merge_state(pb)
    ra.merge_state(rb)
    _states_equal(pa, ra)
    assert pa.update_count == ra.update_count == N_BATCHES
    np.testing.assert_allclose(_np(pa.compute()), np.asarray(ra.compute()), atol=atol, rtol=rtol)
    np.testing.assert_allclose(_np(pa.compute()), epoch, atol=atol, rtol=rtol)


@pytest.mark.parametrize("average", ["macro", "micro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_accuracy(average, ignore_index):
    kwargs = dict(num_classes=C, average=average, ignore_index=ignore_index)
    _three_levels(
        lambda: tc.MulticlassAccuracy(**kwargs, device="cpu"),
        lambda: jc.MulticlassAccuracy(**kwargs),
        _batches(seed=11, ignore_index=ignore_index),
        ACC_ATOL,
    )


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize(
    ("thresholds", "probs", "ignore_index"), [(T, True, -1), (T, False, -1), (None, True, None)]
)
def test_multiclass_auroc(average, thresholds, probs, ignore_index):
    kwargs = dict(num_classes=C, average=average, thresholds=thresholds, ignore_index=ignore_index)
    _three_levels(
        lambda: tc.MulticlassAUROC(**kwargs, device="cpu"),
        lambda: jc.MulticlassAUROC(**kwargs),
        _batches(seed=23, ignore_index=ignore_index, probs=probs),
        AUROC_ATOL,
    )


@pytest.mark.parametrize("name", ["MulticlassPrecision", "MulticlassRecall", "MulticlassF1Score", "MulticlassFBetaScore"])
@pytest.mark.parametrize("average", ["macro", "micro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_precision_recall_fbeta(name, average, ignore_index):
    """Multiclass precision, recall and F-beta at the three levels; logits take K1's gate."""
    kwargs = dict(num_classes=C, average=average, ignore_index=ignore_index)
    if name == "MulticlassFBetaScore":
        kwargs["beta"] = 2.0
    _three_levels(
        lambda: getattr(tc, name)(**kwargs, device="cpu"),
        lambda: getattr(jc, name)(**kwargs),
        _batches(seed=13, ignore_index=ignore_index),
        ACC_ATOL,
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    ("name", "kwargs"),
    [
        ("MulticlassROC", dict(thresholds=T)),
        ("MulticlassROC", dict(thresholds=None)),
        ("MulticlassAveragePrecision", dict(thresholds=T, average="macro")),
        ("MulticlassAveragePrecision", dict(thresholds=T, average="weighted")),
        ("MulticlassAveragePrecision", dict(thresholds=None, average="none")),
        ("MulticlassAveragePrecision", dict(thresholds=None, average="weighted")),
    ],
)
def test_multiclass_roc_and_average_precision(name, kwargs):
    """Multiclass ROC and average precision at the three levels."""
    from tests.torch_parity import three_levels

    args = dict(num_classes=C, ignore_index=-1, **kwargs)
    three_levels(
        lambda: getattr(tc, name)(**args, device="cpu"),
        lambda: getattr(jc, name)(**args),
        [(p, t, p) for p, t in _batches(seed=17, ignore_index=-1, probs=True)],
        AUROC_ATOL,
    )


def test_staged_per_class_counts_need_no_boolean_index():
    """Integer label inputs take the staged per-class count: invalid rows go to
    ``_bincount``'s dropped bin, so the update runs on shapes alone (the meta device
    cannot run the ``nonzero`` a boolean index needs, nor ``torch.bincount``'s sizing)."""
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _multiclass_stat_scores_update

    preds = torch.empty(300, 1, dtype=torch.int64, device="meta")
    counts = _multiclass_stat_scores_update(preds, preds, C, average="macro", ignore_index=-1)
    assert [tuple(x.shape) for x in counts] == [(C,)] * 4 and counts[0].dtype == torch.int32


@pytest.mark.parametrize("t", [2, 5, 100, 200, 1000])
def test_int_thresholds_equal_jax_float32_linspace_bit_for_bit(t):
    """``thresholds=T`` is ``jnp.linspace(0, 1, T)`` as the JAX package builds it in
    float32 (its default mode and the TPU's); ``torch.linspace`` is one ulp off at some
    points (18 of 200), which is the fault this holds repaired."""
    with jax.enable_x64(False):
        want = np.asarray(jnp.linspace(0, 1, t))
    got = _adjust_threshold_arg(t, torch.device("cpu")).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", ["MulticlassPrecisionRecallCurve", "MulticlassAUROC"])
def test_scores_on_int_thresholds_bin_as_in_the_jax_package(name):
    """600 scores placed exactly on the 200 thresholds, JAX in 32-bit mode: the binned
    states are equal and the values agree to 1e-5."""
    n_thr, n_cls = 200, 3
    with jax.enable_x64(False):
        thr = np.asarray(jnp.linspace(0, 1, n_thr))
        off_by_one_ulp = thr[torch.linspace(0, 1, n_thr).numpy() != thr]
        rng = np.random.default_rng(41)
        batches = [(thr[rng.integers(0, n_thr, (50, n_cls))], rng.integers(0, n_cls, 50)) for _ in range(4)]
        assert np.isin(np.concatenate([p for p, _ in batches]), off_by_one_ulp).any()
        port = getattr(tc, name)(num_classes=n_cls, thresholds=n_thr, device="cpu")
        ref = getattr(jc, name)(num_classes=n_cls, thresholds=n_thr)
        for preds, target in batches:
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        _states_equal(port, ref)
        got, want = port.compute(), ref.compute()
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=AUROC_ATOL, rtol=0)


@pytest.mark.parametrize(
    ("kwargs", "shape"),
    [
        (dict(top_k=2), (BATCH, C)),  # top-k one-hot path
        (dict(multidim_average="samplewise"), (BATCH, C, 3)),  # samplewise cat-list states
        (dict(average="micro"), None),  # integer label inputs, micro counters
        (dict(average="none"), None),  # integer label inputs, confusion matrix
    ],
)
def test_multiclass_stat_scores_staged_paths(kwargs, shape):
    """The configurations K1's gate sends to the staged format/update stages."""
    rng = np.random.default_rng(31)
    batches = []
    for _ in range(N_BATCHES):
        if shape is None:
            preds = rng.integers(0, C, BATCH)
            target = rng.integers(0, C, BATCH)
        else:
            preds = rng.standard_normal(shape).astype(np.float32)
            target = rng.integers(0, C, (shape[0], *shape[2:]))
        target[:3] = -1
        batches.append((preds, target))
    args = dict(num_classes=C, ignore_index=-1, **kwargs)
    # macro stat scores are float32 means of counts in the tens: a few ulp relative
    _three_levels(
        lambda: tc.MulticlassStatScores(**args, device="cpu"),
        lambda: jc.MulticlassStatScores(**args),
        batches,
        ACC_ATOL,
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    ("port_cls", "ref_cls", "kwargs", "atol"),
    [
        (tc.MulticlassAccuracy, jc.MulticlassAccuracy, dict(num_classes=C), ACC_ATOL),
        (tc.MulticlassAUROC, jc.MulticlassAUROC, dict(num_classes=C, thresholds=T), AUROC_ATOL),
        (tc.MulticlassAUROC, jc.MulticlassAUROC, dict(num_classes=C), AUROC_ATOL),
    ],
)
def test_sync_through_injected_gather(port_cls, ref_cls, kwargs, atol):
    """A two-rank world emulated by a gather that returns the local state twice."""
    sync = dict(dist_sync_fn=lambda x, group=None: [x, x], distributed_available_fn=lambda: True)
    port, ref = port_cls(**kwargs, **sync, device="cpu"), ref_cls(**kwargs, **sync)
    for preds, target in _batches(seed=5, probs=True):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(_np(port.compute()), np.asarray(ref.compute()), atol=atol, rtol=0)
    _states_equal(port, ref)  # unsynced again after compute
    with port.sync_context(dist_sync_fn=port.dist_sync_fn):
        for attr in port._defaults:
            synced, local = getattr(port, attr), port._cache[attr]
            if isinstance(local, list):
                assert torch.equal(synced, torch.cat(local + local))
            else:
                assert torch.equal(synced, 2 * local)
    _states_equal(port, ref)


def test_engine_kwargs_are_rejected():
    """``compiled_update`` takes a bool or None (the JAX package's message otherwise);
    ``scan_steps`` and ``async_dispatch`` take the JAX package's values (coerced as its
    ``coerce_k`` / ``coerce_inflight`` do) and reject the rest with its messages."""
    for value in (True, False, None):
        assert tc.MulticlassAccuracy(num_classes=C, device="cpu", compiled_update=value).compiled_update is value
    with pytest.raises(ValueError, match="`compiled_update` to be a `bool` or `None`"):
        tc.MulticlassAccuracy(num_classes=C, device="cpu", compiled_update=1)
    accepted = {"scan_steps": (None, 0, False, 2, 8, 1024), "async_dispatch": (None, 0, False, True, 1, 2, 16)}
    rejected = {"scan_steps": (True, 1, -2, 1025, 2.5), "async_dispatch": (-1, 17, 2.5, "2")}
    for kw in accepted:
        for value in accepted[kw]:
            port = getattr(tc.MulticlassAccuracy(num_classes=C, device="cpu", **{kw: value}), kw)
            ref = getattr(jc.MulticlassAccuracy(num_classes=C, **{kw: value}), kw)
            assert port == ref and type(port) is type(ref), (kw, value, port, ref)
        for value in rejected[kw]:
            with pytest.raises(Exception) as jax_err:
                jc.MulticlassAccuracy(num_classes=C, **{kw: value})
            with pytest.raises(TorchMetricsUserError) as port_err:
                tc.MulticlassAccuracy(num_classes=C, device="cpu", **{kw: value})
            assert str(port_err.value) == str(jax_err.value)


def test_states_live_on_the_requested_device_and_inputs_are_placed():
    metric = tc.MulticlassAccuracy(num_classes=C, device="cpu")
    assert metric.device == torch.device("cpu") and metric.tp.dtype == torch.int32
    preds, target = _batches(seed=3)[0]
    metric.update(preds, target)  # numpy inputs are placed with torch.as_tensor
    assert metric.tp.device == torch.device("cpu")
    clone = metric.clone()
    assert torch.equal(clone.tp, metric.tp) and clone.update_count == 1


_GLOO = textwrap.dedent(
    """
    import os, sys, torch, torch.distributed as dist, torch.multiprocessing as mp
    sys.path.insert(0, {root!r})

    def run(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=2, rank=rank)
        from torchmetrics_tpu_torch import MulticlassAccuracy
        from torchmetrics_tpu_torch.parallel import gather_all_tensors
        out = gather_all_tensors(torch.arange(3 + rank, dtype=torch.float32))
        assert [o.tolist() for o in out] == [[0.0, 1.0, 2.0], [0.0, 1.0, 2.0, 3.0]], out
        m = MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
        preds = torch.eye(3)[torch.tensor([0, 1, 2, rank])]
        m.update(preds, torch.tensor([0, 1, 2, 0]))
        value = float(m.compute())
        assert abs(value - 7 / 8) < 1e-6, value  # rank 1 misses one row of 4
        assert int(m.tp.sum()) == 4 - rank  # the local state is restored after the sync
        dist.destroy_process_group()

    if __name__ == "__main__":
        import socket
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        mp.spawn(run, args=(port,), nprocs=2, join=True)
    """
)


def test_gather_all_tensors_over_gloo(tmp_path):
    """Two CPU processes on ``torch.distributed`` (gloo): ragged gather and synced compute."""
    script = tmp_path / "gloo_sync.py"
    script.write_text(_GLOO.format(root=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
