"""The port's seven wrappers against the JAX package's, on the CPU.

``Running``, ``ClasswiseWrapper``, ``MinMaxMetric``, ``MultioutputWrapper``,
``MultitaskWrapper``, ``MetricTracker`` and ``BootStrapper`` over the port's
classification metrics and aggregators, on the same seeded numpy batches as their JAX
twins, at the three protocol levels of ``tests/differential/harness.py`` where the
wrapper has them: each batch's ``forward`` value, the epoch ``compute``, and the
``merge_state`` fold of two replicas (of the wrapper's states, or of its inner metrics
where the wrapper keeps none). Counts agree exactly, ratios within 1e-6, AUROC and AP
within 1e-5. The binned curves run the JAX package in 32-bit mode, as its TPU path
does (in 64-bit mode its thresholds are float64). ``BootStrapper`` parity hands both
packages the same index draws through each package's ``_bootstrap_sampler``.

Also: a ``Running`` whose base metric runs under the update engine must copy the
engine's static buffer into its ring slot (the next replay overwrites the buffer).
"""

from __future__ import annotations

import doctest
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.wrappers.bootstrapping as jboot
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.wrappers.bootstrapping as tboot
from tests.torch_parity import assert_close, np_
from torchmetrics_tpu_torch.engine import engine_context

C, N, N_BATCHES, LABELS = 5, 32, 4, 4
RATIO_ATOL, CURVE_ATOL = 1e-6, 1e-5
_RNG = np.random.default_rng(11)


def _probs(shape):
    e = np.exp(_RNG.standard_normal(shape))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


MC = [(_probs((N, C)), _RNG.integers(0, C, N)) for _ in range(N_BATCHES)]
ML = [(_RNG.uniform(0, 1, (N, LABELS)).astype(np.float32), _RNG.integers(0, 2, (N, LABELS))) for _ in range(N_BATCHES)]
LOSS = [_RNG.standard_normal(n).astype(np.float32) for n in (6, 1, 9, 4)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(x)


def _both(batch):
    return tuple(_t(x) for x in batch), tuple(_j(x) for x in batch)


def _close(got, want, atol=RATIO_ATOL, msg=""):
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for k in want:
            _close(got[k], want[k], atol, f"{msg}[{k}]")
        return
    assert_close(got, want, atol, msg=msg)


# ------------------------------------------------------------------ Running


@pytest.mark.parametrize(
    ("make_port", "make_ref"),
    [
        (lambda: tm.RunningSum(window=3, device="cpu"), lambda: jtm.RunningSum(window=3)),
        (lambda: tm.RunningMean(window=2, nan_strategy=0.0, device="cpu"), lambda: jtm.RunningMean(window=2, nan_strategy=0.0)),
        (lambda: tm.Running(tm.SumMetric(device="cpu"), window=1), lambda: jtm.Running(jtm.SumMetric(), window=1)),
        (lambda: tm.Running(tm.MeanMetric(device="cpu"), window=5), lambda: jtm.Running(jtm.MeanMetric(), window=5)),
    ],
    ids=["sum-3", "mean-2", "sum-1", "mean-5"],
)
def test_running_matches_jax(make_port, make_ref):
    port, ref = make_port(), make_ref()
    for i, b in enumerate(LOSS):
        _close(port(_t(b)), ref(_j(b)), msg=f"forward {i}")
        _close(port.compute(), ref.compute(), msg=f"compute {i}")
    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, b in enumerate(LOSS):
        (pa if i % 2 else pb).update(_t(b))
        (ra if i % 2 else rb).update(_j(b))
    pa.merge_state(pb)
    ra.merge_state(rb)
    _close(pa.compute(), ra.compute(), msg="merge_state")
    port.reset()
    ref.reset()
    port.update(_t(LOSS[0]))
    ref.update(_j(LOSS[0]))
    _close(port.compute(), ref.compute(), msg="after reset")


def test_running_slot_copies_the_engine_buffer():
    """Under the engine the base metric's state is a static buffer that its next replay
    writes in place; a ring slot holding that buffer would read the newest batch."""
    batches = [_t(np.full(3, v, dtype=np.float32)) for v in (1.0, 2.0, 3.0, 4.0, 5.0)]
    ref = jtm.RunningSum(window=3, nan_strategy=0.0)
    eager = tm.RunningSum(window=3, nan_strategy=0.0, device="cpu")
    with engine_context(True):
        engine = tm.RunningSum(window=3, nan_strategy=0.0, device="cpu")
        for i, b in enumerate(batches):
            ref.update(_j(b.numpy()))
            eager.update(b)
            engine.update(b)
            want = np.asarray(ref.compute())
            assert float(eager.compute()) == float(want), i
            assert float(engine.compute()) == float(want), i
    assert float(want) == 36.0
    st = engine.base_metric._engine.stats
    assert st.dispatches == len(batches) and st.eager_fallbacks == 0, st.as_dict()
    assert engine._engine.stats.fallback_reasons == {"nested-metric": len(batches)}


def test_running_raises_like_jax():
    with pytest.raises(ValueError, match="to be an instance"):
        tm.Running(1)
    with pytest.raises(ValueError, match="positive integer"):
        tm.Running(tm.SumMetric(device="cpu"), window=0)
    with pytest.raises(ValueError, match="full_state_update"):
        tm.Running(tm.MaxMetric(device="cpu"))


# ------------------------------------------------------------------ ClasswiseWrapper, MinMaxMetric


@pytest.mark.parametrize("labels", [None, ["a", "b", "c", "d", "e"]])
def test_classwise_matches_jax(labels):
    def make_port():
        return tm.ClasswiseWrapper(tm.MulticlassAccuracy(num_classes=C, average=None, device="cpu"), labels=labels)

    def make_ref():
        return jtm.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=C, average=None), labels=labels)

    port, ref = make_port(), make_ref()
    for i, batch in enumerate(MC):
        pt, jx = _both(batch)
        _close(port(*pt), ref(*jx), msg=f"forward {i}")
    _close(port.compute(), ref.compute(), msg="compute")
    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, batch in enumerate(MC):
        pt, jx = _both(batch)
        (pa if i % 2 else pb).update(*pt)
        (ra if i % 2 else rb).update(*jx)
    pa.metric.merge_state(pb.metric)
    ra.metric.merge_state(rb.metric)
    _close(pa.compute(), ra.compute(), msg="merge_state")
    port.reset()
    assert port.metric.update_count == 0


def test_classwise_in_a_collection_keeps_prefix():
    coll = tm.MetricCollection(
        {"acc": tm.ClasswiseWrapper(tm.MulticlassAccuracy(num_classes=C, average=None, device="cpu"))}, prefix="pre_"
    )
    ref = jtm.MetricCollection({"acc": jtm.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=C, average=None))}, prefix="pre_")
    pt, jx = _both(MC[0])
    coll.update(*pt)
    ref.update(*jx)
    _close(coll.compute(), ref.compute(), msg="collection")


def test_minmax_matches_jax():
    def make_port():
        return tm.MinMaxMetric(tm.MulticlassAccuracy(num_classes=C, device="cpu"))

    def make_ref():
        return jtm.MinMaxMetric(jc.MulticlassAccuracy(num_classes=C))

    port, ref = make_port(), make_ref()
    for i, batch in enumerate(MC):
        pt, jx = _both(batch)
        _close(port(*pt), ref(*jx), msg=f"forward {i}")
        _close(port.compute(), ref.compute(), msg=f"compute {i}")
    port.reset()
    ref.reset()  # the extrema survive a reset in both packages
    pt, jx = _both(MC[0])
    port.update(*pt)
    ref.update(*jx)
    _close(port.compute(), ref.compute(), msg="after reset")
    with pytest.raises(RuntimeError, match="scalar"):
        bad = tm.MinMaxMetric(tm.MulticlassAccuracy(num_classes=C, average=None, device="cpu"))
        bad.update(*pt)
        bad.compute()


# ------------------------------------------------------------------ MultioutputWrapper


def _with_nan_rows(batches):
    out = []
    for p, t in batches:
        p = p.copy()
        p[[1, 7], [0, 2]] = np.nan
        p[20, :] = np.nan
        out.append((p, t))
    return out


@pytest.mark.parametrize(
    ("base", "remove_nans", "squeeze", "nans"),
    [
        ("auroc", False, True, False),
        ("auroc", True, True, False),
        ("accuracy", True, False, True),
        ("accuracy", False, False, False),
    ],
)
def test_multioutput_matches_jax(base, remove_nans, squeeze, nans):
    if base == "auroc":
        make_base_port = lambda: tm.BinaryAUROC(thresholds=11, device="cpu")  # noqa: E731
        make_base_ref, atol = lambda: jc.BinaryAUROC(thresholds=11), CURVE_ATOL  # noqa: E731
    else:
        make_base_port = lambda: tm.BinaryAccuracy(device="cpu")  # noqa: E731
        make_base_ref, atol = lambda: jc.BinaryAccuracy(), RATIO_ATOL  # noqa: E731
    kw = dict(num_outputs=LABELS, remove_nans=remove_nans, squeeze_outputs=squeeze)
    batches = (_with_nan_rows(ML) if nans else ML)[:2]
    with jax.enable_x64(False):
        port, ref = tm.MultioutputWrapper(make_base_port(), **kw), jtm.MultioutputWrapper(make_base_ref(), **kw)
        for i, batch in enumerate(batches):
            pt, jx = _both(batch)
            _close(port(*pt), ref(*jx), atol, msg=f"forward {i}")
        _close(port.compute(), ref.compute(), atol, msg="compute")
        for pm, rm in zip(port.metrics, ref.metrics):
            for attr in rm._defaults:
                np.testing.assert_array_equal(np_(getattr(pm, attr)), np.asarray(getattr(rm, attr)), err_msg=attr)
        pa, pb = tm.MultioutputWrapper(make_base_port(), **kw), tm.MultioutputWrapper(make_base_port(), **kw)
        ra, rb = jtm.MultioutputWrapper(make_base_ref(), **kw), jtm.MultioutputWrapper(make_base_ref(), **kw)
        for i, batch in enumerate(batches):
            pt, jx = _both(batch)
            (pa if i % 2 else pb).update(*pt)
            (ra if i % 2 else rb).update(*jx)
        for a, b in zip(pa.metrics, pb.metrics):
            a.merge_state(b)
        for a, b in zip(ra.metrics, rb.metrics):
            a.merge_state(b)
        _close(pa.compute(), ra.compute(), atol, msg="merge_state")


def test_multioutput_nan_removal_reads_the_host_once_per_update(monkeypatch):
    calls = []
    real = torch.Tensor.tolist

    def counting(self):
        calls.append(tuple(self.shape))
        return real(self)

    wrapper = tm.MultioutputWrapper(tm.BinaryAccuracy(validate_args=False, device="cpu"), num_outputs=LABELS)
    pt, _ = _both(_with_nan_rows(ML)[0])
    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    wrapper.update(*pt)
    assert calls == [(LABELS,)]


# ------------------------------------------------------------------ MultitaskWrapper


def test_multitask_matches_jax():
    def make_port():
        return tm.MultitaskWrapper({
            "classes": tm.MulticlassAccuracy(num_classes=C, device="cpu"),
            "labels": tm.MultilabelAveragePrecision(num_labels=LABELS, thresholds=11, device="cpu"),
            "group": tm.MetricCollection({"f1": tm.MulticlassF1Score(num_classes=C, device="cpu"),
                                          "cm": tm.MulticlassConfusionMatrix(num_classes=C, device="cpu")}),
        })

    def make_ref():
        return jtm.MultitaskWrapper({
            "classes": jc.MulticlassAccuracy(num_classes=C),
            "labels": jc.MultilabelAveragePrecision(num_labels=LABELS, thresholds=11),
            "group": jtm.MetricCollection({"f1": jc.MulticlassF1Score(num_classes=C),
                                           "cm": jc.MulticlassConfusionMatrix(num_classes=C)}),
        })

    def inputs(i, to):
        return (
            {"classes": to(MC[i][0]), "labels": to(ML[i][0]), "group": to(MC[i][0])},
            {"classes": to(MC[i][1]), "labels": to(ML[i][1]), "group": to(MC[i][1])},
        )

    with jax.enable_x64(False):
        port, ref = make_port(), make_ref()
        for i in range(2):
            _close(port(*inputs(i, _t)), ref(*inputs(i, _j)), CURVE_ATOL, msg=f"forward {i}")
        _close(port.compute(), ref.compute(), CURVE_ATOL, msg="compute")
        pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
        for i in range(2):
            (pa if i % 2 else pb).update(*inputs(i, _t))
            (ra if i % 2 else rb).update(*inputs(i, _j))
        for name in ("classes", "labels"):
            pa.task_metrics[name].merge_state(pb.task_metrics[name])
            ra.task_metrics[name].merge_state(rb.task_metrics[name])
            _close(pa.task_metrics[name].compute(), ra.task_metrics[name].compute(), CURVE_ATOL, msg=f"merge {name}")
    with pytest.raises(ValueError, match="same keys"):
        port.update({"classes": _t(MC[0][0])}, {"classes": _t(MC[0][1])})
    with pytest.raises(TypeError, match="Metric or a MetricCollection"):
        tm.MultitaskWrapper({"x": 1})


# ------------------------------------------------------------------ MetricTracker


@pytest.mark.parametrize("maximize", [True, False, [True, False], [False, True]], ids=str)
def test_tracker_matches_jax(maximize):
    collection = isinstance(maximize, list)
    if collection:
        port = tm.MetricTracker(tm.MetricCollection({"acc": tm.MulticlassAccuracy(num_classes=C, device="cpu"),
                                                     "f1": tm.MulticlassF1Score(num_classes=C, device="cpu")}), maximize)
        ref = jtm.MetricTracker(jtm.MetricCollection({"acc": jc.MulticlassAccuracy(num_classes=C),
                                                      "f1": jc.MulticlassF1Score(num_classes=C)}), maximize)
    else:
        port = tm.MetricTracker(tm.MulticlassAccuracy(num_classes=C, device="cpu"), maximize)
        ref = jtm.MetricTracker(jc.MulticlassAccuracy(num_classes=C), maximize)
    with pytest.raises(ValueError, match="increment"):
        port.update(*_both(MC[0])[0])
    for epoch in range(3):
        port.increment()
        ref.increment()
        for i in range(epoch, N_BATCHES):
            pt, jx = _both(MC[i])
            _close(port(*pt), ref(*jx), msg=f"epoch {epoch} forward {i}")
        _close(port.compute(), ref.compute(), msg=f"epoch {epoch} compute")
    assert port.n_steps == ref.n_steps == 3
    _close(port.compute_all(), ref.compute_all(), msg="compute_all")
    best, step = port.best_metric(return_step=True)
    ref_best, ref_step = ref.best_metric(return_step=True)
    assert step == ref_step
    _close(best, ref_best, msg="best_metric")
    _close(port.best_metric(), ref.best_metric(), msg="best_metric value")


def test_tracker_validates_maximize_like_jax():
    with pytest.raises(TypeError):
        tm.MetricTracker(1)
    with pytest.raises(ValueError, match="single bool"):
        tm.MetricTracker(tm.SumMetric(device="cpu"), maximize=[True])
    with pytest.raises(ValueError, match="len of argument"):
        tm.MetricTracker(tm.MetricCollection({"s": tm.SumMetric(device="cpu")}), maximize=[True, False])


# ------------------------------------------------------------------ BootStrapper


@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
@pytest.mark.parametrize(
    ("make_port", "make_ref", "batches"),
    [
        (lambda: tm.MulticlassAccuracy(num_classes=C, device="cpu"), lambda: jc.MulticlassAccuracy(num_classes=C), MC),
        (lambda: tm.MeanMetric(device="cpu"), lambda: jtm.MeanMetric(), [(b,) for b in LOSS]),
    ],
    ids=["accuracy", "mean"],
)
def test_bootstrapper_matches_jax_on_the_same_draws(monkeypatch, sampling_strategy, make_port, make_ref, batches):
    """Both packages get one numpy draw per copy per update through their own sampler
    (Poisson draws vary in length, and the JAX package compiles each length: fewer)."""
    draws = {"port": [], "jax": []}
    rng = np.random.RandomState(5)

    def draw(size, strategy):
        if strategy == "poisson":
            idx = np.repeat(np.arange(size), rng.poisson(1, size))
        else:
            idx = rng.randint(0, size, size)
        draws["port"].append(idx)
        draws["jax"].append(idx)

    monkeypatch.setattr(tboot, "_bootstrap_sampler", lambda size, strategy, gen: torch.from_numpy(draws["port"].pop(0)))
    monkeypatch.setattr(jboot, "_bootstrap_sampler", lambda size, strategy, r: jnp.asarray(draws["jax"].pop(0)))
    copies = 2 if sampling_strategy == "poisson" else 6
    batches = batches[:2] if sampling_strategy == "poisson" else batches
    kw = dict(num_bootstraps=copies, mean=True, std=True, quantile=[0.1, 0.9], raw=True, sampling_strategy=sampling_strategy)
    port = tm.BootStrapper(make_port(), **kw)
    ref = jtm.BootStrapper(make_ref(), **{**kw, "quantile": jnp.asarray([0.1, 0.9])})
    for b in batches:
        for _ in range(copies):
            draw(b[0].shape[0], sampling_strategy)
        port.update(*(_t(x) for x in b))
        ref.update(*(_j(x) for x in b))
    assert not draws["port"] and not draws["jax"]
    for pm, rm in zip(port.metrics, ref.metrics):
        for attr in rm._defaults:
            np.testing.assert_allclose(np_(getattr(pm, attr)), np.asarray(getattr(rm, attr)), rtol=1e-6, err_msg=attr)
    _close(port.compute(), ref.compute(), msg="compute")


@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
def test_bootstrap_sampler_draws_with_replacement(sampling_strategy):
    gen = torch.Generator().manual_seed(1)
    idx = tboot._bootstrap_sampler(50, sampling_strategy, gen).numpy()
    assert idx.min() >= 0 and idx.max() < 50
    counts = np.bincount(idx, minlength=50)
    assert (counts >= 2).any() and (counts == 0).any()
    again = tboot._bootstrap_sampler(50, sampling_strategy, torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(idx, again)


def test_bootstrapper_raises_like_jax():
    with pytest.raises(ValueError, match="to be an instance"):
        tm.BootStrapper(1)
    with pytest.raises(ValueError, match="sampling_strategy"):
        tm.BootStrapper(tm.SumMetric(device="cpu"), sampling_strategy="foo")


# ------------------------------------------------------------------ examples


@pytest.mark.parametrize(
    "module",
    [
        "torchmetrics_tpu_torch.aggregation",
        "torchmetrics_tpu_torch.metric",
        "torchmetrics_tpu_torch.diag.costs",
        "torchmetrics_tpu_torch.wrappers.bootstrapping",
        "torchmetrics_tpu_torch.wrappers.classwise",
        "torchmetrics_tpu_torch.wrappers.minmax",
        "torchmetrics_tpu_torch.wrappers.multioutput",
        "torchmetrics_tpu_torch.wrappers.multitask",
        "torchmetrics_tpu_torch.wrappers.running",
        "torchmetrics_tpu_torch.wrappers.tracker",
    ],
)
def test_docstring_examples(module):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
