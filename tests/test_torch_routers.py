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
