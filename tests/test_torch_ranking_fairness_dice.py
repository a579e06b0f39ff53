"""Multilabel ranking, group fairness and Dice: the port (on the CPU) against the JAX package.

Each modular metric at the three protocol levels of ``tests/differential/harness.py``
(``torch_parity.three_levels`` / ``three_levels_args`` for the three-argument fairness
update), the functional forms, and the edge cases that differ most easily between the
packages: tied scores in the rankings (all-equal rows, scores rounded to 0.1), ignored
labels, an empty group, every Dice input format and average. Under the compiled engine
each metric replays where the JAX engine compiles and falls back where it falls back,
with the engine state equal to eager; a samplewise Dice's cat lists carry over from the
JAX package.

Tolerances: counts exact; ranking sums and values 1e-5 (per-row ratio sums added in
another order); fairness and Dice ratios 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional.classification as tf
from tests.torch_parity import assert_close, assert_states, engine_split, jax_scores, three_levels, three_levels_args
from torchmetrics_tpu_torch.interop import state_from_jax

RANK_ATOL = 1e-5
ATOL = 1e-6
L, C, G = 5, 4, 3
SIZES = (24, 17, 9)
RANKING = ("MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss")
RANKING_FN = {
    "MultilabelCoverageError": "multilabel_coverage_error",
    "MultilabelRankingAveragePrecision": "multilabel_ranking_average_precision",
    "MultilabelRankingLoss": "multilabel_ranking_loss",
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- multilabel ranking


def _ranking_batches(seed: int, kind: str = "logits", ignore_index=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        preds = rng.standard_normal((n, L)).astype(np.float32)
        if kind == "probs":
            preds = (1 / (1 + np.exp(-preds))).astype(np.float32)
        elif kind == "rounded":  # many ties within a row
            preds = np.round(1 / (1 + np.exp(-preds)), 1).astype(np.float32)
        elif kind == "equal":
            preds = np.full((n, L), 0.5, dtype=np.float32)
        target = rng.integers(0, 2, (n, L))
        target[: n // 8] = 0  # no relevant label
        target[n // 8: n // 4] = 1  # every label relevant
        if ignore_index is not None:
            target[rng.random((n, L)) < 0.1] = ignore_index
        out.append((preds, target, jax_scores(preds, threshold=0.0) if kind == "logits" else preds))
    return out


@pytest.mark.parametrize("name", RANKING)
@pytest.mark.parametrize("kind", ["logits", "probs", "rounded", "equal"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_ranking(name, kind, ignore_index):
    three_levels(
        lambda: getattr(tc, name)(L, ignore_index=ignore_index, device="cpu"),
        lambda: getattr(jc, name)(L, ignore_index=ignore_index),
        _ranking_batches(0, kind, ignore_index), atol=RANK_ATOL, float_state_atol=RANK_ATOL,
    )


@pytest.mark.parametrize("name", RANKING)
def test_ranking_functional(name):
    for preds, target, jpreds in _ranking_batches(1, "rounded", -1):
        fn = RANKING_FN[name]
        assert_close(
            getattr(tf, fn)(_t(preds), _t(target), L, ignore_index=-1),
            getattr(jf, fn)(jnp.asarray(jpreds), jnp.asarray(target), L, ignore_index=-1), RANK_ATOL, msg=fn,
        )


def test_ranking_stable_tie_order():
    """All-equal rows: the ranking loss's inverse permutation comes from two stable
    argsorts, so tied labels keep their index order, as ``jnp.argsort`` keeps it."""
    preds = np.zeros((6, L), dtype=np.float32)
    target = np.array([[1, 0, 0, 0, 0], [0, 0, 0, 0, 1], [1, 1, 0, 0, 0], [0, 0, 0, 1, 1], [0, 1, 0, 1, 0], [1, 0, 1, 0, 1]])
    got = tf.multilabel_ranking_loss(_t(preds), _t(target), L)
    want = jf.multilabel_ranking_loss(jnp.asarray(preds), jnp.asarray(target), L)
    assert_close(got, want, 1e-7)


def test_ranking_validation():
    with pytest.raises(ValueError, match="floating"):
        tf.multilabel_coverage_error(torch.zeros(2, L, dtype=torch.long), torch.zeros(2, L, dtype=torch.long), L)
    with pytest.raises(ValueError, match="num_labels"):
        tc.MultilabelRankingLoss(1, device="cpu")


# ---------------------------------------------------------------- group fairness


def _fairness_batches(seed: int, kind: str = "logits", ignore_index=None, num_groups: int = G, empty_group=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        logits = (2 * rng.standard_normal(n)).astype(np.float32)
        preds = logits if kind == "logits" else (1 / (1 + np.exp(-logits))).astype(np.float32)
        target = rng.integers(0, 2, n)
        groups = rng.integers(0, num_groups, n)
        groups[:num_groups] = np.arange(num_groups)  # the functional forms count the distinct groups
        if empty_group is not None:
            groups = np.where(groups == empty_group, (empty_group + 1) % num_groups, groups)
        if ignore_index is not None:
            target[rng.random(n) < 0.15] = ignore_index
        out.append(((preds, target, groups), (jax_scores(preds), target, groups)))
    return out


@pytest.mark.parametrize("kind", ["logits", "probs"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("empty_group", [None, 1])
def test_group_stat_rates(kind, ignore_index, empty_group):
    three_levels_args(
        lambda: tc.BinaryGroupStatRates(G, ignore_index=ignore_index, device="cpu"),
        lambda: jc.BinaryGroupStatRates(G, ignore_index=ignore_index),
        _fairness_batches(2, kind, ignore_index, empty_group=empty_group), atol=ATOL,
    )


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_fairness(task, ignore_index, threshold):
    batches = _fairness_batches(3, "probs", ignore_index)
    if task == "demographic_parity":  # no target: a warning when one is given
        batches = [((p, g), (jp, g)) for (p, _, g), (jp, _, _) in batches]

        def port():
            m = tc.BinaryFairness(G, task, threshold, ignore_index, device="cpu")
            m.update = (lambda update: lambda p, g: update(p, groups=g))(m.update)
            return m

        def ref():
            m = jc.BinaryFairness(G, task, threshold, ignore_index)
            m.update = (lambda update: lambda p, g: update(p, groups=g))(m.update)
            return m

        three_levels_args(port, ref, batches, atol=ATOL)
        return
    three_levels_args(
        lambda: tc.BinaryFairness(G, task, threshold, ignore_index, device="cpu"),
        lambda: jc.BinaryFairness(G, task, threshold, ignore_index),
        batches, atol=ATOL,
    )


@pytest.mark.parametrize("ignore_index", [None, -1])
def test_fairness_functional(ignore_index):
    for (p, t, g), (jp, _, _) in _fairness_batches(4, "logits", ignore_index):
        tp, tt, tg, jpa, jt, jg = _t(p), _t(t), _t(g), jnp.asarray(jp), jnp.asarray(t), jnp.asarray(g)
        kw = dict(ignore_index=ignore_index)
        assert_close(tf.binary_groups_stat_rates(tp, tt, tg, G, **kw), jf.binary_groups_stat_rates(jpa, jt, jg, G, **kw), ATOL)
        assert_close(tf.demographic_parity(tp, tg, **kw), jf.demographic_parity(jpa, jg, **kw), ATOL)
        assert_close(tf.equal_opportunity(tp, tt, tg, **kw), jf.equal_opportunity(jpa, jt, jg, **kw), ATOL)
        for task in ("demographic_parity", "equal_opportunity", "all"):
            assert_close(
                tf.binary_fairness(tp, tt, tg, task, **kw), jf.binary_fairness(jpa, jt, jg, task, **kw), ATOL, msg=task
            )


def test_fairness_validation():
    preds, target = torch.rand(6), torch.randint(0, 2, (6,))
    for groups in (torch.tensor([0, 1, 2, 3, 0, 1]), torch.tensor([-1, 0, 1, 0, 1, 0])):
        with pytest.raises(ValueError, match="largest number in the groups"):
            tc.BinaryGroupStatRates(3, device="cpu").update(preds, target, groups)
    with pytest.raises(ValueError, match="integer type"):
        tc.BinaryGroupStatRates(3, device="cpu").update(preds, target, torch.zeros(6))
    with pytest.raises(ValueError, match="num_groups"):
        tc.BinaryFairness(1, device="cpu")
    with pytest.raises(ValueError, match="task"):
        tc.BinaryFairness(2, task="parity", device="cpu")
    with pytest.raises(ValueError, match="groups"):
        tc.BinaryFairness(2, device="cpu").update(preds, target)
    with pytest.warns(UserWarning, match="does not require a target"):
        tc.BinaryFairness(2, task="demographic_parity", device="cpu").update(preds, target, torch.zeros(6, dtype=torch.long))


# ---------------------------------------------------------------- Dice


def _dice_batches(seed: int, fmt: str, ignore_index=None):
    """``(port preds, target, JAX preds)`` in one of the legacy formats."""
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        if fmt in ("scores", "multidim_scores"):
            shape = (n,) if fmt == "scores" else (n, 3)
            target = rng.integers(0, C, shape)
            preds = rng.standard_normal((n, C, *shape[1:])).astype(np.float32)
            np.put_along_axis(preds, np.where(rng.random(shape) < 0.6, target, rng.integers(0, C, shape))[:, None], 3.0, axis=1)
        elif fmt == "labels":
            target = rng.integers(0, C, n)
            preds = np.where(rng.random(n) < 0.6, target, rng.integers(0, C, n))
        elif fmt == "binary_probs":
            target = rng.integers(0, 2, n)
            preds = rng.random(n).astype(np.float32)
        else:  # binary labels
            target = rng.integers(0, 2, n)
            preds = rng.integers(0, 2, n)
        if ignore_index is not None and fmt in ("scores", "multidim_scores", "labels"):
            target = np.where(rng.random(target.shape) < 0.1, ignore_index, target)
        out.append((preds, target, preds))
    return out


@pytest.mark.parametrize(
    "fmt, kwargs",
    [
        ("scores", dict(average="micro", num_classes=C)),
        ("scores", dict(average="macro", num_classes=C)),
        ("scores", dict(average="weighted", num_classes=C)),
        ("scores", dict(average="none", num_classes=C)),
        ("scores", dict(average="macro", num_classes=C, ignore_index=0)),
        ("scores", dict(average="micro", num_classes=C, top_k=2)),
        ("multidim_scores", dict(average="macro", num_classes=C)),
        ("multidim_scores", dict(average="micro", num_classes=C, mdmc_average="samplewise")),
        ("multidim_scores", dict(average="samples", num_classes=C)),
        ("labels", dict(average="macro", num_classes=C)),
        ("labels", dict(average="micro", num_classes=C, ignore_index=1)),
        ("binary_probs", dict(average="micro", threshold=0.3)),
        ("binary_labels", dict(average="macro", num_classes=2)),
    ],
)
def test_dice(fmt, kwargs):
    batches = _dice_batches(5, fmt, kwargs.get("ignore_index"))
    three_levels(lambda: tc.Dice(**kwargs, device="cpu"), lambda: jc.Dice(**kwargs), batches, atol=ATOL)
    for preds, target, _ in batches:
        assert_close(tf.dice(_t(preds), _t(target), **kwargs), jf.dice(jnp.asarray(preds), jnp.asarray(target), **kwargs), ATOL)


def test_dice_argmax_rule():
    """Tied and NaN scores: the first index wins a tie and NaN is maximal, as K1 and
    ``jnp.argmax`` decide."""
    preds = np.array([[0.3, 0.3, 0.1, 0.3], [0.1, np.nan, 0.2, np.nan], [0.5, 0.2, 0.5, 0.1]], dtype=np.float32)
    target = np.array([1, 1, 2])
    for average in ("micro", "none"):
        assert_close(
            tf.dice(_t(preds), _t(target), average=average, num_classes=C),
            jf.dice(jnp.asarray(preds), jnp.asarray(target), average=average, num_classes=C), ATOL,
        )


def test_dice_validation():
    with pytest.raises(ValueError, match="average"):
        tc.Dice(average="mean", device="cpu")
    with pytest.raises(ValueError, match="number of classes"):
        tc.Dice(average="macro", device="cpu")
    with pytest.raises(ValueError, match="ignore_index"):
        tc.Dice(num_classes=3, ignore_index=3, device="cpu")
    assert isinstance(ttm.Dice(device="cpu"), tc.Dice)


# ---------------------------------------------------------------- the engine


def _rank_pairs(seed):
    return [((p, t), (jp, t)) for p, t, jp in _ranking_batches(seed, "logits", -1)]


def _fair_pairs(seed):
    return _fairness_batches(seed, "logits", -1)


@pytest.mark.parametrize(
    "name, make_port, make_ref, batches, refusal, replays",
    [
        ("dice", lambda: tc.Dice(num_classes=C, average="macro", device="cpu"),
         lambda: jc.Dice(num_classes=C, average="macro"),
         lambda: [((p, t), (jp, t)) for p, t, jp in _dice_batches(6, "scores", -1)], "", True),
        ("dice samplewise", lambda: tc.Dice(num_classes=C, average="samples", device="cpu"),
         lambda: jc.Dice(num_classes=C, average="samples"),
         lambda: [((p, t), (jp, t)) for p, t, jp in _dice_batches(6, "multidim_scores")], "", False),
        ("ranking AP", lambda: tc.MultilabelRankingAveragePrecision(L, ignore_index=-1, validate_args=False, device="cpu"),
         lambda: jc.MultilabelRankingAveragePrecision(L, ignore_index=-1, validate_args=False), lambda: _rank_pairs(7), "", True),
        ("coverage", lambda: tc.MultilabelCoverageError(L, ignore_index=-1, validate_args=False, device="cpu"),
         lambda: jc.MultilabelCoverageError(L, ignore_index=-1, validate_args=False), lambda: _rank_pairs(7), "", True),
        ("ranking loss", lambda: tc.MultilabelRankingLoss(L, validate_args=False, device="cpu"),
         lambda: jc.MultilabelRankingLoss(L, validate_args=False), lambda: _rank_pairs(7), "", True),
        ("ranking loss, validating", lambda: tc.MultilabelRankingLoss(L, ignore_index=-1, device="cpu"),
         lambda: jc.MultilabelRankingLoss(L, ignore_index=-1), lambda: _rank_pairs(7), "data-sized-output:_unique2", False),
        ("fairness", lambda: tc.BinaryFairness(G, ignore_index=-1, validate_args=False, device="cpu"),
         lambda: jc.BinaryFairness(G, ignore_index=-1, validate_args=False), lambda: _fair_pairs(8), "", True),
        ("group stat rates", lambda: tc.BinaryGroupStatRates(G, validate_args=False, device="cpu"),
         lambda: jc.BinaryGroupStatRates(G, validate_args=False), lambda: _fairness_batches(8), "", True),
        ("fairness, validating", lambda: tc.BinaryFairness(G, device="cpu"), lambda: jc.BinaryFairness(G),
         lambda: _fairness_batches(8), "data-sized-output:_unique2", False),
    ],
)
def test_engine_replays_where_the_jax_engine_compiles(name, make_port, make_ref, batches, refusal, replays):
    st = engine_split(make_port, make_ref, batches(), refusal)
    if replays:
        assert st.eager_fallbacks == 0 and st.dispatches == len(SIZES), name
    else:
        assert st.dispatches == 0 and st.eager_fallbacks == len(SIZES), name


def test_dice_samplewise_state_carried_from_jax():
    batches = _dice_batches(9, "multidim_scores")
    ref, port = jc.Dice(num_classes=C, average="samples"), tc.Dice(num_classes=C, average="samples", device="cpu")
    ref.persistent(True)
    for p, t, _ in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.update_count == 2 and len(port.tp) == 2 and port.tp[0].dtype == torch.int32
    for p, t, _ in batches[2:]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(_t(p), _t(t))
    assert_states(port, ref)
    assert_close(port.compute(), ref.compute(), ATOL)
