"""Four faults of the port against the JAX package, and the multiclass curve's
reduction signature.

- Top-k order: ``select_topk`` takes the first k of a stable sort of IEEE total-order
  keys, so tied scores pick the lower index first, +0.0 ranks above -0.0 and a NaN
  ranks by its sign bit (+NaN first, -NaN last), as ``jax.lax.top_k`` does
  (``Tensor.topk`` picks other indices among ties; a float sort ties the zeros and
  ranks every NaN first). The top-k update reads nothing back to the host, so it runs
  as a graph step under the engine.
- Kendall's tau-c on a column with one distinct value: the distinct count is an exact
  integer, so tau-c is 0/0 = NaN at every size, as scipy gives. The JAX package's float
  Σ 1/t gives ±0.0 at some sizes (n = 9); both give NaN at n = 12.
- The sigmoid: float32 logits go through float64 and are rounded once, so a logit's
  probability does not depend on the batch it sits in (``torch.sigmoid`` on the CPU
  gives float32 results that change with the tensor's shape).
- A state tensor the caller holds under the engine is the static buffer the next
  replay writes: it holds the new count. The JAX package's donation deletes it. The
  port keeps this difference, documents it and pins it here.
- The multiclass PR curve declares the binned reduction signature, so a collection of
  a multiclass AUROC and the fixed-point metrics over the same thresholds is one group
  from the start and counts with kernel K2 once per update.

Tolerances: counts exact; ratios 1e-6; exact-mode average precision 1e-5.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from tests.torch_parity import assert_close, three_levels
from torchmetrics_tpu import MetricCollection as JaxMetricCollection
from torchmetrics_tpu.engine import engine_context as jax_engine_context
from torchmetrics_tpu.functional.classification.dice import dice as jax_dice
from torchmetrics_tpu.functional.regression import kendall_rank_corrcoef as jax_kendall
from torchmetrics_tpu.utilities.data import select_topk as jax_select_topk
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.engine import compiled, engine_context
from torchmetrics_tpu_torch.functional.classification.dice import dice
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_format,
    _multilabel_precision_recall_curve_format,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _sigmoid_if_logits
from torchmetrics_tpu_torch.functional.regression import kendall_rank_corrcoef
from torchmetrics_tpu_torch.utilities.data import select_topk

RATIO_ATOL, AP_ATOL = 1e-6, 1e-5
C = 10
# the package attribute of this name is the function the package exports
port_curve = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")


# ------------------------------------------------------------------ top-k tie order


@pytest.mark.parametrize(
    ("row", "k", "want"),
    [
        ([0.0] * 10, 3, [0, 1, 2]),
        ([0.1, float("nan"), 0.5, 0.5, 0.2], 2, [1, 2]),
        ([0.3, 0.3, 0.3, 0.9, 0.3], 3, [0, 1, 3]),
        ([float("nan"), 0.0, float("nan"), 1.0], 2, [0, 2]),
    ],
)
def test_select_topk_breaks_ties_like_lax_top_k(row, k, want):
    x = np.asarray([row], dtype=np.float32)
    got = select_topk(torch.from_numpy(x), k, dim=1).numpy()
    ref = np.asarray(jax_select_topk(jnp.asarray(x), k, dim=1))
    np.testing.assert_array_equal(got, ref)
    assert np.flatnonzero(got[0]).tolist() == want


@pytest.mark.parametrize("dim", [1, 2])
def test_select_topk_on_rounded_scores(dim):
    """Scores rounded to 0.1 (ties in most rows) along either class axis."""
    x = np.round(np.random.default_rng(3).random((64, 7, 6)), 1).astype(np.float32)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(
            select_topk(torch.from_numpy(x), k, dim=dim).numpy(), np.asarray(jax_select_topk(jnp.asarray(x), k, dim=dim))
        )


def _tied_batches(kind: str, seed: int):
    """Dirichlet scores rounded to 0.1, or all-equal rows, over ragged batches."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (64, 37, 50):
        if kind == "rounded":
            preds = np.round(rng.dirichlet(np.ones(C), n), 1).astype(np.float32)
        else:
            preds = np.full((n, C), 0.1, dtype=np.float32)
            preds[: n // 3] = 0.0
        target = rng.integers(0, C, n)
        out.append((preds, target, preds))
    return out


@pytest.mark.parametrize("name", ["MulticlassAccuracy", "MulticlassStatScores", "MulticlassF1Score"])
@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("kind", ["rounded", "all-equal"])
def test_top_k_ties_match_jax(name, top_k, kind):
    kwargs = dict(num_classes=C, top_k=top_k, average=None)
    three_levels(
        lambda: getattr(tc, name)(**kwargs, device="cpu"),
        lambda: getattr(jc, name)(**kwargs),
        _tied_batches(kind, seed=top_k),
        RATIO_ATOL,
    )


def test_rounded_dirichlet_top2_accuracy_per_class():
    """``MulticlassAccuracy(num_classes=10, top_k=2, average=None)`` on Dirichlet scores
    rounded to 0.1: every class equals the JAX package's; ``Tensor.topk``'s tie order
    gives other values on the same inputs."""
    rng = np.random.default_rng(0)
    preds = np.round(rng.dirichlet(np.ones(C), 200), 1).astype(np.float32)
    target = rng.integers(0, C, 200)
    port = tc.MulticlassAccuracy(num_classes=C, top_k=2, average=None, device="cpu")
    ref = jc.MulticlassAccuracy(num_classes=C, top_k=2, average=None)
    got = port(torch.from_numpy(preds), torch.from_numpy(target)).numpy()
    want = np.asarray(ref(jnp.asarray(preds), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, atol=RATIO_ATOL, rtol=0)
    by_topk = torch.zeros(200, C, dtype=torch.int32).scatter_(1, torch.from_numpy(preds).topk(2, dim=1).indices, 1)
    by_sort = select_topk(torch.from_numpy(preds), 2, dim=1)
    assert not torch.equal(by_topk, by_sort)  # the inputs do hold ties that decide a count


@pytest.mark.parametrize("top_k", [2, 3])
def test_top_k_update_replays_under_the_engine(top_k):
    """The top-k path reads nothing back to the host (the stable sort, and a one-hot
    made by comparison, where ``torch.nn.functional.one_hot`` checks its labels on the
    host): under the engine every update is a graph step, as in the JAX package."""
    batches = _tied_batches("rounded", seed=7)
    with engine_context(True):
        port = tc.MulticlassAccuracy(num_classes=C, top_k=top_k, average=None, validate_args=False, device="cpu")
        for preds, target, _ in batches:
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
    with jax_engine_context(True, donate=True):
        ref = jc.MulticlassAccuracy(num_classes=C, top_k=top_k, average=None, validate_args=False)
        for preds, target, _ in batches:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
    st, ref_st = port._engine.stats, ref._engine.stats
    assert (st.eager_fallbacks, st.dispatches) == (ref_st.eager_fallbacks, ref_st.dispatches) == (0, len(batches))
    assert_close(port.compute(), ref.compute(), RATIO_ATOL)


def _signed_rows(kind: str, seed: int, n: int = 64, classes: int = 5) -> np.ndarray:
    """Logits rounded to integers (rows holding both -0.0 and +0.0), or rows with an
    ``inf - inf`` NaN, whose sign bit is set on x86 (a -NaN), beside +NaN."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, classes)) * 0.6).astype(np.float32)
    if kind == "nan":
        with np.errstate(invalid="ignore"):
            neg_nan = np.float32(np.inf) - np.float32(np.inf)
        x[::3, 1] = np.copysign(np.float32(np.nan), np.float32(-1.0))
        x[1::4, 3] = neg_nan
        x[2::5, 0] = np.float32(np.nan)
        x[::7, 4] = -np.inf
    assert (np.signbit(x) & (x == 0)).any() or np.isnan(x).any()
    return x


@pytest.mark.parametrize("kind", ["zeros", "nan"])
def test_select_topk_orders_signed_zeros_and_nan_as_lax_top_k(kind):
    x = _signed_rows(kind, seed=1)
    for k in (2, 3, 4):
        np.testing.assert_array_equal(
            select_topk(torch.from_numpy(x), k, dim=1).numpy(), np.asarray(jax_select_topk(jnp.asarray(x), k, dim=1))
        )


@pytest.mark.parametrize("kind", ["zeros", "nan"])
@pytest.mark.parametrize("engine", [False, True])
def test_top2_micro_accuracy_on_signed_rows(kind, engine):
    """``MulticlassAccuracy(5, top_k=2, average="micro")`` equals the JAX package's on
    rows that hold both zeros or a -NaN, eagerly and under the engine (where every
    update replays)."""
    batches = [(_signed_rows(kind, seed), np.random.default_rng(seed).integers(0, 5, 64)) for seed in (2, 3)]
    kwargs = dict(num_classes=5, top_k=2, average="micro", validate_args=False)
    with engine_context(engine):
        port = tc.MulticlassAccuracy(**kwargs, device="cpu")
        for preds, target in batches:
            port.update(torch.from_numpy(preds), torch.from_numpy(target))
        got = port.compute()
    ref = jc.MulticlassAccuracy(**kwargs)
    for preds, target in batches:
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(got, ref.compute(), RATIO_ATOL, msg=kind)
    if engine:
        assert (port._engine.stats.dispatches, port._engine.stats.eager_fallbacks) == (len(batches), 0)


@pytest.mark.parametrize("kind", ["zeros", "nan"])
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_dice_top2_on_signed_rows(kind, average):
    preds = _signed_rows(kind, seed=4)
    target = np.random.default_rng(4).integers(0, 5, preds.shape[0])
    got = dice(torch.from_numpy(preds), torch.from_numpy(target), average=average, top_k=2, num_classes=5)
    want = jax_dice(jnp.asarray(preds), jnp.asarray(target), average=average, top_k=2, num_classes=5)
    assert_close(got, want, RATIO_ATOL, msg=f"{kind} {average}")


# ------------------------------------------------------------------ Kendall's tau-c on one distinct value


@pytest.mark.parametrize("n", [6, 7, 9, 12, 13])
def test_kendall_tau_c_on_a_constant_column_is_nan(n):
    """A constant column has one tie group: (m - 1) / m is exactly 0 and tau-c is NaN at
    every size. A float Σ 1/t lands a hair off 1 at n = 6, 7, 13 (and in the JAX package
    at n = 9), where it gave ±0.0."""
    x = np.full(n, 0.5, dtype=np.float32)
    y = np.round(np.linspace(0, 1, n), 1).astype(np.float32)
    for a, b in ((x, y), (y, x)):
        assert np.isnan(float(kendall_rank_corrcoef(torch.from_numpy(a), torch.from_numpy(b), variant="c")))
    # taus a and b on the same column are 0/0 in both packages, and stay so
    assert np.isnan(float(kendall_rank_corrcoef(torch.from_numpy(x), torch.from_numpy(y), variant="b")))


@pytest.mark.parametrize(("n", "jax_is_nan"), [(9, False), (12, True)])
def test_kendall_tau_c_constant_column_against_jax(n, jax_is_nan):
    """The divergence kept on purpose: at n = 9 the JAX package gives ±0.0, at n = 12 NaN;
    the port gives NaN at both."""
    x = np.full(n, 0.5, dtype=np.float32)
    y = np.round(np.linspace(0, 1, n), 1).astype(np.float32)
    want = float(jax_kendall(jnp.asarray(x), jnp.asarray(y), variant="c"))
    assert np.isnan(want) == jax_is_nan and (jax_is_nan or want == 0.0)
    assert np.isnan(float(kendall_rank_corrcoef(torch.from_numpy(x), torch.from_numpy(y), variant="c")))


# ------------------------------------------------------------------ the sigmoid


@pytest.mark.parametrize("big", [40, 57, 1 << 16])
@pytest.mark.parametrize("small", [5, 7])
def test_sigmoid_does_not_depend_on_the_batch_shape(big, small):
    """The same logits give bit-identical probabilities sliced from a large batch and
    taken as a small one: in the stat scores' ``_sigmoid_if_logits`` and in the binary
    and multilabel curves' formats."""
    width = 40 if big < 1000 else 8
    diffs = 0
    for seed in range(20 if big < 1000 else 2):
        logits = (np.random.default_rng(seed).standard_normal((big, width)) * 3).astype(np.float32)
        whole, part = torch.from_numpy(logits), torch.from_numpy(logits[:small].copy())
        diffs += int((_sigmoid_if_logits(whole)[:small] != _sigmoid_if_logits(part)).sum())
        p_whole, _, _ = _binary_precision_recall_curve_format(whole, torch.zeros(whole.shape, dtype=torch.int64))
        p_part, _, _ = _binary_precision_recall_curve_format(part, torch.zeros(part.shape, dtype=torch.int64))
        diffs += int((p_whole[: p_part.numel()] != p_part).sum())
        m_whole, _, _ = _multilabel_precision_recall_curve_format(whole, torch.zeros(whole.shape, dtype=torch.int64), width)
        m_part, _, _ = _multilabel_precision_recall_curve_format(part, torch.zeros(part.shape, dtype=torch.int64), width)
        diffs += int((m_whole[:small] != m_part).sum())
    assert diffs == 0


@pytest.mark.parametrize("seed", range(20))
def test_exact_multilabel_ap_on_logits_with_repeated_rows(seed):
    """Exact-mode multilabel AP on logits, a third batch repeating 5 rows of the first
    with other targets: a repeated logit keeps its probability, so its copies tie, as
    in the JAX package (a tie broken by one ulp moves AP by up to ~1e-4)."""
    rng = np.random.default_rng(seed)
    labels = 5
    first = (rng.standard_normal((40, labels)) * 2).astype(np.float32)
    second = (rng.standard_normal((57, labels)) * 2).astype(np.float32)
    batches = [first, second, first[:5].copy()]
    targets = [rng.integers(0, 2, b.shape) for b in batches]
    port = tc.MultilabelAveragePrecision(num_labels=labels, average="macro", device="cpu")
    ref = jc.MultilabelAveragePrecision(num_labels=labels, average="macro")
    for preds, target in zip(batches, targets):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), atol=AP_ATOL, rtol=0)


# ------------------------------------------------------------------ held state tensors


def test_held_state_tensor_follows_the_engine():
    """Under the engine, ``h = m.tp; m.update(...)`` leaves ``h`` holding the new count
    (``h`` is the static buffer the replay writes); in the JAX package the donation
    deletes ``h``. The engine's module docstring says so."""
    assert "h = m.tp; m.update(...)" in " ".join(compiled.__doc__.split())
    rng = np.random.default_rng(11)
    batches = [(rng.random((32, 5)).astype(np.float32), rng.integers(0, 5, 32)) for _ in range(3)]
    with engine_context(True):
        m = tc.MulticlassStatScores(5, average=None, validate_args=False, device="cpu")
        for preds, target in batches[:2]:
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
        held = m.tp
        before = held.clone()
        m.update(*(torch.from_numpy(x) for x in batches[2]))
        alone = tc.MulticlassStatScores(5, average=None, validate_args=False, device="cpu", compiled_update=False)
        alone.update(*(torch.from_numpy(x) for x in batches[2]))
        assert held is m.tp and compiled.is_static(held)
        assert torch.equal(held, before + alone.tp)
    with jax_engine_context(True, donate=True):
        ref = jc.MulticlassStatScores(5, average=None, validate_args=False)
        for preds, target in batches[:2]:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        held_ref = ref.tp
        ref.update(*(jnp.asarray(x) for x in batches[2]))
        with pytest.raises(RuntimeError, match="deleted"):
            np.asarray(held_ref)
        np.testing.assert_array_equal(m.tp.numpy(), np.asarray(ref.tp))


# ------------------------------------------------------------------ the multiclass curve's signature


def _fixed_point_members(mod, thresholds, **dev):
    return {
        "auroc": mod.MulticlassAUROC(C, thresholds=thresholds, **dev),
        "rfp": mod.MulticlassRecallAtFixedPrecision(C, min_precision=0.5, thresholds=thresholds, **dev),
        "pfr": mod.MulticlassPrecisionAtFixedRecall(C, min_recall=0.5, thresholds=thresholds, **dev),
        "sas": mod.MulticlassSpecificityAtSensitivity(C, min_sensitivity=0.5, thresholds=thresholds, **dev),
    }


def test_multiclass_curves_share_one_k2_count_from_the_first_update(monkeypatch):
    calls = []
    real = port_curve.multi_threshold_confmat
    monkeypatch.setattr(port_curve, "multi_threshold_confmat", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(5)
    batches = [(rng.dirichlet(np.ones(C), n).astype(np.float32), rng.integers(0, C, n)) for n in (64, 40, 64)]
    port = MetricCollection(_fixed_point_members(tc, 20, device="cpu"))
    assert port.compute_groups == {0: ["auroc", "pfr", "rfp", "sas"]}  # merged when built
    ref = JaxMetricCollection(_fixed_point_members(jc, 20))
    for step, (preds, target) in enumerate(batches, start=1):
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        assert len(calls) == step  # one count per update, the first included
    assert sorted(map(sorted, port.compute_groups.values())) == sorted(map(sorted, ref.compute_groups.values()))
    got, want = port.compute(), ref.compute()
    alone = _fixed_point_members(tc, 20, device="cpu")
    for name, metric in alone.items():
        for preds, target in batches:
            metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(got[name], metric.compute(), 0.0, msg=name)  # the group changes no value
        assert_close(got[name], want[name], AP_ATOL, msg=name)
