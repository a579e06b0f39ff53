"""Helpers shared by the parity tests of the port's binary, multilabel and router slices.

The same seeded numpy batches go through the port (on the CPU) and through the JAX
package at the three protocol levels of ``tests/differential/harness.py``: the
per-batch ``forward`` value, the fold of two replicas via ``merge_state``, and the epoch
``compute``.

Sigmoid: ``jax.nn.sigmoid`` (XLA on the CPU, ``1 / (1 + exp(-x))`` in float32) and the
port's ``_sigmoid`` (float32 logits go through float64 and are rounded once) differ by
up to two ulp (``test_torch_binary.py::test_sigmoid_difference_is_bounded``). Where
logits go in, ``jax_scores`` hands the JAX side the same logits when the two sigmoids
put every score on the same side of every threshold, and the port's own probabilities
otherwise, so integer counts can be held exactly. Exact-mode score lists hold sigmoid
outputs themselves; they are held to ``SIGMOID_ATOL``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torchmetrics_tpu_torch.utilities.compute import _sigmoid

# two ulp of a float32 in [0.5, 1): the largest sigmoid difference seen, and allowed
SIGMOID_ATOL = 2.0**-23


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, atol: float, rtol: float = 0.0, msg: str = "") -> None:
    """Recursive over tuples, lists and dicts; integer arrays must be equal."""
    if isinstance(got, dict):
        assert isinstance(want, dict) and list(got) == list(want), f"{msg}: keys {list(got)} vs {list(want)}"
        for k in got:
            assert_close(got[k], want[k], atol, rtol, f"{msg}[{k}]")
        return
    if isinstance(got, (tuple, list)):
        assert isinstance(want, (tuple, list)) and len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, atol, rtol, f"{msg}[{i}]")
        return
    g, w = np_(got), np.asarray(want)
    assert g.shape == w.shape, f"{msg}: {g.shape} vs {w.shape}"
    if g.dtype.kind in "iub" and w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=msg)
    else:
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=msg)


def assert_states(port, ref, float_atol: float = 0.0, float_rtol: float = 0.0) -> None:
    """Integer states equal; float states (exact-mode score lists, float sums) within
    ``float_atol`` and ``float_rtol``; exactly equal when both are 0."""
    for attr in ref._defaults:
        p, r = getattr(port, attr), getattr(ref, attr)
        if isinstance(r, list):
            assert len(p) == len(r), attr
            if not r:
                continue
            p, r = torch.cat(p), np.concatenate([np.asarray(x) for x in r])
        else:
            assert p.dtype in (torch.int32, torch.float32), attr
        p, r = np_(p), np.asarray(r)
        if p.dtype.kind == "f" and (float_atol or float_rtol):
            np.testing.assert_allclose(p, r, atol=float_atol, rtol=float_rtol, err_msg=attr)
        else:
            np.testing.assert_array_equal(p, r, err_msg=attr)


def thresholds_array(thresholds) -> Optional[np.ndarray]:
    """The float32 thresholds a ``thresholds=`` argument gives (``None``: exact mode)."""
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        with jax.enable_x64(False):
            return np.asarray(jnp.linspace(0, 1, thresholds))
    return np.asarray(thresholds, dtype=np.float32).reshape(-1)


def jax_scores(preds: np.ndarray, thresholds=None, threshold: float = 0.5) -> np.ndarray:
    """What the JAX side takes for the port's ``preds``: the same array, unless they are
    logits whose two sigmoids fall on different sides of ``threshold`` or of one of
    ``thresholds``; then the port's probabilities (all in [0, 1], so no sigmoid runs)."""
    if preds.dtype.kind != "f" or np.all((preds >= 0) & (preds <= 1)):
        return preds
    j = np.asarray(jax.nn.sigmoid(jnp.asarray(preds)))
    t = _sigmoid(torch.from_numpy(preds)).numpy()
    edges = [np.float32(threshold)]
    thr = thresholds_array(thresholds)
    if thr is not None:
        edges.extend(thr)
    # counts and bins compare with > (stat scores) and >= (curves): hold both sides
    same = all(np.array_equal(j > e, t > e) and np.array_equal(j >= e, t >= e) for e in edges)
    return preds if same else t


def three_levels(
    make_port: Callable,
    make_ref: Callable,
    batches: Sequence[tuple],
    atol: float,
    rtol: float = 0.0,
    float_state_atol: float = 0.0,
    float_state_rtol: float = 0.0,
) -> None:
    """``batches``: ``(port preds, target, JAX preds)``; each level's values within the
    tolerance, states as ``assert_states`` holds them."""
    three_levels_args(
        make_port, make_ref, [((p, t), (jp, t)) for p, t, jp in batches], atol, rtol, float_state_atol, float_state_rtol
    )


def three_levels_args(
    make_port: Callable,
    make_ref: Callable,
    batches: Sequence[tuple],
    atol: float,
    rtol: float = 0.0,
    float_state_atol: float = 0.0,
    float_state_rtol: float = 0.0,
) -> None:
    """``three_levels`` for updates of any arity: ``batches`` holds ``(port args, JAX
    args)`` pairs of numpy arrays."""

    def port_args(args):
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]

    def ref_args(args):
        return [jnp.asarray(a) for a in args]

    state_tol = (float_state_atol, float_state_rtol)
    port, ref = make_port(), make_ref()
    for i, (pargs, jargs) in enumerate(batches):
        assert_close(port(*port_args(pargs)), ref(*ref_args(jargs)), atol, rtol, f"forward {i}")
    assert_states(port, ref, *state_tol)
    epoch = ref.compute()
    assert_close(port.compute(), epoch, atol, rtol, "compute")

    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, (pargs, jargs) in enumerate(batches):
        first = i < len(batches) // 2
        (pa if first else pb).update(*port_args(pargs))
        (ra if first else rb).update(*ref_args(jargs))
    pa.merge_state(pb)
    ra.merge_state(rb)
    assert_states(pa, ra, *state_tol)
    assert pa.update_count == ra.update_count == len(batches)
    assert_close(pa.compute(), ra.compute(), atol, rtol, "merged compute")
    assert_close(pa.compute(), epoch, atol, rtol, "merged against one instance")


def engine_split(make_port: Callable, make_ref: Callable, batches: Sequence[tuple], port_refusal: str = "") -> dict:
    """The port's and the JAX package's compiled engines over the same ``(port args, JAX
    args)`` batches: replay (dispatch) and fallback counts and reasons must agree, with
    the JAX engine's first-step ``trace-failed:*`` refusal named as the port's guard
    names it (``port_refusal``); the engine-on port states must be bit-equal to an eager
    port run. The JAX side runs in 32-bit mode, the port's dtypes: in 64-bit mode an
    eager step can change a state's dtype, and the JAX engine then traces the next step
    of the same shapes again. Returns the port's stats."""
    from torchmetrics_tpu.engine import engine_context as jax_engine_context
    from torchmetrics_tpu_torch.engine import engine_context

    with jax.enable_x64(False), jax_engine_context(True, donate=True):
        ref = make_ref()
        for _, jargs in batches:
            ref.update(*[jnp.asarray(a) for a in jargs])
    with engine_context(True):
        port = make_port()
        for pargs, _ in batches:
            port.update(*[torch.from_numpy(np.ascontiguousarray(a)) for a in pargs])
    with engine_context(False):
        eager = make_port()
        for pargs, _ in batches:
            eager.update(*[torch.from_numpy(np.ascontiguousarray(a)) for a in pargs])
    assert_states(port, eager)
    assert_close(port.compute(), eager.compute(), 0.0, 0.0, "engine against eager")
    pst, jst = port._engine.stats, ref._engine.stats
    jax_reasons = {(port_refusal if r.startswith("trace-failed:") else r): n for r, n in jst.fallback_reasons.items()}
    assert dict(pst.fallback_reasons) == jax_reasons, (dict(pst.fallback_reasons), dict(jst.fallback_reasons))
    assert (pst.dispatches, pst.eager_fallbacks) == (jst.dispatches, jst.eager_fallbacks)
    return pst


# ---------------------------------------------------------------- the engine tier

#: the config #2 collection (stat scores, macro and weighted accuracy, binned AUROC, two
#: confusion matrices) at a test width
CONFIG2_CLASSES, CONFIG2_THRESHOLDS = 5, 20


def tier_batches(sizes: Sequence[int], seed: int = 0, classes: int = 5) -> list:
    """Seeded ``(scores (n, classes) float32 in [0, 1), labels (n,) int64)`` batches."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, classes).astype(np.float32), rng.randint(0, classes, n).astype(np.int64)) for n in sizes]


def to_port(batch) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in batch)


def to_jax(batch) -> tuple:
    return tuple(jnp.asarray(x) for x in batch)


def config2_members(port: bool, classes: int = CONFIG2_CLASSES, **kwargs) -> dict:
    """The config #2 members, on the port (CPU) or the JAX package."""
    if port:
        from torchmetrics_tpu_torch import classification as pkg

        kwargs = {"device": "cpu", **kwargs}
    else:
        from torchmetrics_tpu import classification as pkg
    return {
        "stats": pkg.MulticlassStatScores(classes, validate_args=False, **kwargs),
        "acc": pkg.MulticlassAccuracy(classes, average="macro", validate_args=False, **kwargs),
        "acc_w": pkg.MulticlassAccuracy(classes, average="weighted", validate_args=False, **kwargs),
        "auroc": pkg.MulticlassAUROC(classes, thresholds=CONFIG2_THRESHOLDS, validate_args=False, **kwargs),
        "confmat": pkg.MulticlassConfusionMatrix(classes, validate_args=False, **kwargs),
        "confmat_t": pkg.MulticlassConfusionMatrix(classes, normalize="true", validate_args=False, **kwargs),
    }


def assert_same_states(port, ref, float_rtol: float = 0.0) -> None:
    """Every registered state of ``port`` against ``ref`` (a port metric or a JAX one):
    integer states equal, float states within ``float_rtol`` (exact when 0)."""
    for attr in ref._defaults:
        p, r = np_(getattr(port, attr)), np.asarray(getattr(ref, attr))
        assert p.shape == r.shape, f"{attr}: {p.shape} vs {r.shape}"
        if p.dtype.kind == "f" and float_rtol:
            np.testing.assert_allclose(p, r, rtol=float_rtol, atol=0, err_msg=attr)
        else:
            np.testing.assert_array_equal(p, r.astype(p.dtype) if r.dtype.kind == p.dtype.kind else r, err_msg=attr)
