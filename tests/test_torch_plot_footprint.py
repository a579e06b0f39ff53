"""``plot`` and ``state_footprint`` of the port against the JAX package's, on the CPU.

Plots are drawn under matplotlib's Agg backend and compared line by line (the data of
every line, its label, the title, the axis labels); the byte counts of
``state_footprint`` must equal the JAX package's for a metric, a list state and a
collection whose compute groups share their states. The classification footprints
run the JAX package in 32-bit mode, as on its TPU path: in 64-bit mode its counters
widen to int64 as they fold, where the port's stay int32.
"""

from __future__ import annotations

import importlib.util

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.utilities.plot as jplot
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.utilities.plot as tplot

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

C = 4
_RNG = np.random.default_rng(5)
_VALUES = [_RNG.standard_normal(n).astype(np.float32) for n in (3, 2, 4)]
_PREDS, _TARGET = _RNG.integers(0, C, 30), _RNG.integers(0, C, 30)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _drawn(ax):
    """What an axis shows: each line's data and label, title, axis labels, legend."""
    legend = ax.get_legend()
    return {
        "lines": [(np.asarray(line.get_xdata(), dtype=float).tolist(), np.asarray(line.get_ydata(), dtype=float).tolist(),
                   line.get_label()) for line in ax.lines],
        "title": ax.get_title(),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "texts": [t.get_text() for t in ax.texts],
        "images": [np.asarray(im.get_array()).tolist() for im in ax.images],
        "ticks": [t.get_text() for t in ax.get_xticklabels()],
    }


def _pair(name, **kwargs):
    port = getattr(tm, name)(device="cpu", **kwargs)
    ref = getattr(jtm, name)(**kwargs)
    for v in _VALUES:
        port.update(torch.from_numpy(v))
        ref.update(jnp.asarray(v))
    return port, ref


@pytest.mark.parametrize("name", ["MeanMetric", "SumMetric", "MaxMetric", "CatMetric"])
def test_metric_plot_matches_jax(name):
    port, ref = _pair(name)
    (_, p_ax), (_, r_ax) = port.plot(), ref.plot()
    assert _drawn(p_ax) == _drawn(r_ax)


def test_plot_of_a_sequence_of_values():
    port, ref = _pair("MeanMetric")
    p_vals = [torch.tensor(v.mean()) for v in _VALUES]
    r_vals = [jnp.asarray(v.mean()) for v in _VALUES]
    assert _drawn(port.plot(p_vals)[1]) == _drawn(ref.plot(r_vals)[1])
    vec_p = [torch.from_numpy(v[:2]) for v in _VALUES]
    vec_r = [jnp.asarray(v[:2]) for v in _VALUES]
    assert _drawn(port.plot(vec_p)[1]) == _drawn(ref.plot(vec_r)[1])


def test_plot_of_a_dict_value_and_a_wrapper():
    port = tm.MinMaxMetric(tm.MulticlassAccuracy(num_classes=C, device="cpu"))
    ref = jtm.MinMaxMetric(jc.MulticlassAccuracy(num_classes=C))
    port.update(torch.from_numpy(_PREDS), torch.from_numpy(_TARGET))
    ref.update(jnp.asarray(_PREDS), jnp.asarray(_TARGET))
    assert _drawn(port.plot()[1]) == _drawn(ref.plot()[1])


@pytest.mark.parametrize("together", [True, False])
def test_collection_plot_matches_jax(together):
    def members(package):
        kw = {"device": "cpu"} if package is tm else {}
        return {"mean": package.MeanMetric(**kw), "sum": package.SumMetric(**kw), "cat": package.CatMetric(**kw)}

    port, ref = tm.MetricCollection(members(tm)), jtm.MetricCollection(members(jtm))
    for v in _VALUES:
        port.update(torch.from_numpy(v))
        ref.update(jnp.asarray(v))
    got, want = port.plot(together=together), ref.plot(together=together)
    if together:
        assert _drawn(got[1]) == _drawn(want[1])
    else:
        assert [_drawn(a) for _, a in got] == [_drawn(a) for _, a in want]


def test_tracker_plot_matches_jax():
    port, ref = tm.MetricTracker(tm.MeanMetric(device="cpu")), jtm.MetricTracker(jtm.MeanMetric())
    for v in _VALUES:
        port.increment()
        ref.increment()
        port.update(torch.from_numpy(v))
        ref.update(jnp.asarray(v))
    assert _drawn(port.plot()[1]) == _drawn(ref.plot()[1])


@pytest.mark.parametrize("labels", [None, ["a", "b", "c", "d"]])
def test_plot_confusion_matrix_matches_jax(labels):
    port = tm.MulticlassConfusionMatrix(num_classes=C, device="cpu")
    port.update(torch.from_numpy(_PREDS), torch.from_numpy(_TARGET))
    confmat = port.compute()
    _, p_ax = tplot.plot_confusion_matrix(confmat, labels=labels)
    _, r_ax = jplot.plot_confusion_matrix(jnp.asarray(confmat.numpy()), labels=labels)
    assert _drawn(p_ax) == _drawn(r_ax)
    per_label = torch.from_numpy(_RNG.integers(0, 9, (5, 2, 2)).astype(np.float32))
    _, p_axs = tplot.plot_confusion_matrix(per_label)
    _, r_axs = jplot.plot_confusion_matrix(jnp.asarray(per_label.numpy()))
    assert [_drawn(a) for a in p_axs] == [_drawn(a) for a in r_axs]
    with pytest.raises(ValueError, match="labels"):
        tplot.plot_confusion_matrix(confmat, labels=["a"])


def test_plot_curve_matches_jax():
    port = tm.MulticlassROC(num_classes=C, thresholds=6, device="cpu")
    ref = jc.MulticlassROC(num_classes=C, thresholds=6)
    probs = _RNG.uniform(0, 1, (30, C)).astype(np.float32)
    port.update(torch.from_numpy(probs), torch.from_numpy(_TARGET))
    ref.update(jnp.asarray(probs), jnp.asarray(_TARGET))
    p_curve, r_curve = port.compute(), ref.compute()
    score = np.linspace(0.2, 0.8, C).astype(np.float32)
    _, p_ax = tplot.plot_curve(p_curve, score=torch.from_numpy(score), legend_name="class", name="ROC")
    _, r_ax = jplot.plot_curve(r_curve, score=jnp.asarray(score), legend_name="class", name="ROC")
    assert _drawn(p_ax) == _drawn(r_ax)
    _, p_ax = tplot.plot_curve((p_curve[0][0], p_curve[1][0]), score=torch.tensor(0.5), label_names=("FPR", "TPR"))
    _, r_ax = jplot.plot_curve((r_curve[0][0], r_curve[1][0]), score=jnp.asarray(0.5), label_names=("FPR", "TPR"))
    assert _drawn(p_ax) == _drawn(r_ax)
    with pytest.raises(ValueError, match="2 or more"):
        tplot.plot_curve((p_curve[0],))


def test_plot_without_matplotlib_raises_the_jax_error(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(ModuleNotFoundError, match="pip install matplotlib"):
        tm.MeanMetric(device="cpu").plot(torch.tensor(1.0))


def test_base_metric_plot_is_not_implemented():
    with pytest.raises(NotImplementedError):
        tm.MulticlassAccuracy(num_classes=C, device="cpu").plot()


# ------------------------------------------------------------------ state_footprint


@pytest.mark.parametrize("name", ["MeanMetric", "SumMetric", "CatMetric"])
def test_metric_footprint_matches_jax(name):
    port, ref = _pair(name)
    got, want = port.state_footprint(), ref.state_footprint()
    assert got["owner"] == want["owner"] and got["per_state"] == want["per_state"]
    assert got["total_bytes"] == want["total_bytes"] > 0


@pytest.mark.parametrize("average", ["micro", "macro", None])
def test_classification_footprint_matches_jax(average):
    port = tm.MulticlassAccuracy(num_classes=C, average=average, device="cpu")
    port.update(torch.from_numpy(_PREDS), torch.from_numpy(_TARGET))
    with jax.enable_x64(False):
        ref = jc.MulticlassAccuracy(num_classes=C, average=average)
        ref.update(jnp.asarray(_PREDS), jnp.asarray(_TARGET))
        assert port.state_footprint()["per_state"] == ref.state_footprint()["per_state"]


def test_collection_footprint_counts_shared_group_states_once():
    def members(package, cls):
        kw = {"device": "cpu"} if package is tm else {}
        return {
            "acc": cls.MulticlassAccuracy(num_classes=C, **kw),
            "f1": cls.MulticlassF1Score(num_classes=C, **kw),
            "prec": cls.MulticlassPrecision(num_classes=C, **kw),
            "cm": cls.MulticlassConfusionMatrix(num_classes=C, **kw),
            "mean": package.MeanMetric(**kw),
        }

    port = tm.MetricCollection(members(tm, tm))
    port.update(torch.from_numpy(_PREDS), torch.from_numpy(_TARGET))
    with jax.enable_x64(False):
        ref = jtm.MetricCollection(members(jtm, jc))
        ref.update(jnp.asarray(_PREDS), jnp.asarray(_TARGET))
        got, want = port.state_footprint(), ref.state_footprint()
    for key in ("owner", "total_bytes", "unique_bytes", "shared_bytes", "per_metric", "groups"):
        assert got[key] == want[key], key
    assert got["shared_bytes"] == 2 * got["per_metric"]["acc"]
    with pytest.raises(TypeError, match="Metric or MetricCollection"):
        from torchmetrics_tpu_torch.diag.costs import state_footprint

        state_footprint(1)
