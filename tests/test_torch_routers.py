"""Task routers: ``Accuracy(task=...)``, ``auroc(..., task=...)`` and the rest, the port
(on the CPU) against the JAX package.

Every modular router returns the port's class for each task, with the router's
defaults passed through, and gives the JAX router's ``forward`` and ``compute`` values
on the same seeded batches; every functional router gives the JAX one's value. Both
refuse a missing width and an unknown task as the JAX package does. Tolerances:
integer outputs exact, ratios 1e-6, AUROC, AP and curve points 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.functional as jfn
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional as tfn
from tests.torch_parity import assert_close

C, L, N = 4, 3, 40
ATOL = 1e-5
TASKS = ["binary", "multiclass", "multilabel"]

# router name -> extra keyword arguments (beyond task / num_classes / num_labels)
MODULAR = {
    "StatScores": {},
    "Accuracy": {},
    "Precision": dict(average="macro"),
    "Recall": dict(average="weighted"),
    "FBetaScore": dict(beta=2.0),
    "F1Score": {},
    "ConfusionMatrix": dict(normalize="true"),
    "PrecisionRecallCurve": dict(thresholds=9),
    "ROC": dict(thresholds=9),
    "AUROC": dict(thresholds=9),
    "AveragePrecision": {},
}
FUNCTIONAL = {
    "stat_scores": {},
    "accuracy": dict(average="macro"),
    "precision": {},
    "recall": dict(average="none"),
    "fbeta_score": dict(beta=0.5),
    "f1_score": {},
    "confusion_matrix": {},
    "precision_recall_curve": dict(thresholds=5),
    "roc": {},
    "auroc": dict(thresholds=7),
    "average_precision": dict(average="weighted"),
}
PORT_CLASS_PREFIX = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}


def _inputs(task: str, seed: int):
    """Probabilities (so no sigmoid or softmax separates the packages) and targets."""
    rng = np.random.default_rng(seed)
    if task == "binary":
        return rng.uniform(0, 1, N).astype(np.float32), rng.integers(0, 2, N)
    if task == "multiclass":
        e = np.exp(rng.standard_normal((N, C)))
        return (e / e.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, C, N)
    return rng.uniform(0, 1, (N, L)).astype(np.float32), rng.integers(0, 2, (N, L))


def _widths(task: str) -> dict:
    return dict(num_classes=C if task == "multiclass" else None, num_labels=L if task == "multilabel" else None)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("router", sorted(MODULAR))
def test_modular_router(router, task):
    kwargs = dict(task=task, **_widths(task), **MODULAR[router])
    port = getattr(ttm, router)(**kwargs, device="cpu")
    ref = getattr(jtm, router)(**kwargs)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__name__.startswith(PORT_CLASS_PREFIX[task]) and isinstance(port, ttm.Metric)
    assert port.device == torch.device("cpu")
    for seed in range(2):
        preds, target = _inputs(task, seed)
        assert_close(
            port(torch.from_numpy(preds), torch.from_numpy(target)),
            ref(jnp.asarray(preds), jnp.asarray(target)),
            ATOL, msg=f"{router} forward",
        )
    assert_close(port.compute(), ref.compute(), ATOL, msg=f"{router} compute")


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("router", sorted(FUNCTIONAL))
def test_functional_router(router, task):
    preds, target = _inputs(task, 7)
    kwargs = dict(task=task, **_widths(task), **FUNCTIONAL[router])
    assert_close(
        getattr(tfn, router)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
        getattr(jfn, router)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
        ATOL, msg=router,
    )


@pytest.mark.parametrize("router", sorted(MODULAR))
def test_modular_router_refusals_match_jax(router):
    for kwargs in (dict(task="multiclass"), dict(task="multilabel"), dict(task="regression")):
        with pytest.raises(ValueError) as port_err:
            getattr(ttm, router)(**kwargs, **MODULAR[router], device="cpu")
        with pytest.raises(ValueError) as ref_err:
            getattr(jtm, router)(**kwargs, **MODULAR[router])
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("router", ["StatScores", "Accuracy", "Precision", "Recall", "FBetaScore", "F1Score"])
def test_stat_scores_routers_refuse_a_missing_top_k(router):
    with pytest.raises(ValueError, match="top_k"):
        getattr(ttm, router)(task="multiclass", num_classes=C, top_k=None, device="cpu")


def test_router_kwargs_reach_the_metric():
    metric = ttm.F1Score(task="multilabel", num_labels=L, threshold=0.3, average="none", ignore_index=-1, device="cpu")
    assert (metric.threshold, metric.average, metric.ignore_index, metric.beta) == (0.3, "none", -1, 1.0)
    metric = ttm.AUROC(task="binary", max_fpr=0.2, thresholds=5, device="cpu")
    assert metric.max_fpr == 0.2 and metric.confmat.shape == (5, 2, 2)
    metric = ttm.StatScores(task="multiclass", num_classes=C, top_k=2, multidim_average="samplewise", device="cpu")
    assert metric.top_k == 2 and metric.tp == []


# the rest of the stat-scores family: router -> (its tasks, extra keyword arguments)
FAMILY_MODULAR = {
    "Specificity": (TASKS, {}),
    "HammingDistance": (TASKS, dict(average="macro")),
    "ExactMatch": (["multiclass", "multilabel"], {}),
    "JaccardIndex": (TASKS, dict(average="weighted")),
    "MatthewsCorrCoef": (TASKS, {}),
    "CohenKappa": (["binary", "multiclass"], dict(weights="linear")),
    "RecallAtFixedPrecision": (TASKS, dict(min_precision=0.5, thresholds=9)),
    "PrecisionAtFixedRecall": (TASKS, dict(min_recall=0.5, thresholds=9)),
    "SpecificityAtSensitivity": (TASKS, dict(min_sensitivity=0.5, thresholds=9)),
}
FAMILY_FUNCTIONAL = {
    "specificity": (TASKS, dict(average="macro")),
    "hamming_distance": (TASKS, {}),
    "exact_match": (["multiclass", "multilabel"], {}),
    "jaccard_index": (TASKS, {}),
    "matthews_corrcoef": (TASKS, {}),
    "cohen_kappa": (["binary", "multiclass"], dict(weights="quadratic")),
    "recall_at_fixed_precision": (TASKS, dict(min_precision=0.6, thresholds=7)),
    "precision_at_fixed_recall": (TASKS, dict(min_recall=0.6)),
    "specificity_at_sensitivity": (TASKS, dict(min_sensitivity=0.6, thresholds=7)),
}


def _family_widths(router: str, task: str) -> dict:
    widths = _widths(task)
    if router.lower().replace("_", "") == "cohenkappa":
        widths.pop("num_labels")  # the kappa router takes no num_labels
    return widths


def _family_cases(table):
    return [(name, task) for name, (tasks, _) in sorted(table.items()) for task in tasks]


@pytest.mark.parametrize(("router", "task"), _family_cases(FAMILY_MODULAR))
def test_family_modular_router(router, task):
    kwargs = dict(task=task, **_family_widths(router, task), **FAMILY_MODULAR[router][1])
    port = getattr(ttm, router)(**kwargs, device="cpu")
    ref = getattr(jtm, router)(**kwargs)
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__name__.startswith(PORT_CLASS_PREFIX[task]) and isinstance(port, ttm.Metric)
    for seed in range(2):
        preds, target = _inputs(task, seed)
        assert_close(
            port(torch.from_numpy(preds), torch.from_numpy(target)),
            ref(jnp.asarray(preds), jnp.asarray(target)),
            ATOL, msg=f"{router} forward",
        )
    assert_close(port.compute(), ref.compute(), ATOL, msg=f"{router} compute")


@pytest.mark.parametrize(("router", "task"), _family_cases(FAMILY_FUNCTIONAL))
def test_family_functional_router(router, task):
    preds, target = _inputs(task, 8)
    kwargs = dict(task=task, **_family_widths(router, task), **FAMILY_FUNCTIONAL[router][1])
    assert_close(
        getattr(tfn, router)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
        getattr(jfn, router)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
        ATOL, msg=router,
    )


@pytest.mark.parametrize("router", sorted(FAMILY_MODULAR))
def test_family_router_refusals_match_jax(router):
    """A missing width, an unknown task and a task the family does not have raise the
    JAX package's errors, word for word."""
    extra = FAMILY_MODULAR[router][1]
    for kwargs in (dict(task="multiclass"), dict(task="multilabel"), dict(task="binary"), dict(task="regression")):
        if kwargs["task"] in FAMILY_MODULAR[router][0] and kwargs["task"] == "binary":
            continue
        with pytest.raises(ValueError) as port_err:
            getattr(ttm, router)(**kwargs, **extra, device="cpu")
        with pytest.raises(ValueError) as ref_err:
            getattr(jtm, router)(**kwargs, **extra)
        assert str(port_err.value) == str(ref_err.value)
