"""Hinge loss and calibration error: the port (on the CPU) against the JAX package.

Binary and multiclass, modular at the three protocol levels of
``tests/differential/harness.py`` (``torch_parity.three_levels``), functional and
through the task routers, over ragged seeded batches of logits and probabilities, with
and without ``ignore_index`` (the ignored rows are dropped on the host in both
packages). Edge cases: a confidence of exactly 1.0 (the extra last bin), one-vs-all on
two classes, squared hinge, every norm. Under the compiled engine both hinge losses and
the multiclass calibration error fall back where the JAX engine does, and the engine
state equals the eager one. Also the ``to_onehot`` repair: a one-hot that reads nothing
back, so an update calling it is captured.

Tolerances: counts exact; hinge sums and values relative 1e-6 (the two sigmoids and
softmaxes differ by an ulp or two); calibration errors 1e-5 (bin sums added in
another order). Calibration inputs that are logits reach the JAX side as the port's
probabilities wherever the two sigmoids would put a confidence on different sides of
a bin edge (``torch_parity.jax_scores``).
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
from tests.torch_parity import assert_close, assert_states, engine_split, jax_scores, three_levels
from torchmetrics_tpu.utilities.data import to_onehot as jax_to_onehot
from torchmetrics_tpu_torch.engine import engine_context
from torchmetrics_tpu_torch.interop import state_from_jax
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import to_onehot

RTOL = 1e-6
CE_ATOL = 1e-5
C = 4
SIZES = (24, 17, 9)
N_BINS = 10


def _binary_batches(seed: int, kind: str = "logits", ignore_index=None, n_bins=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        logits = (2 * rng.standard_normal(n)).astype(np.float32)
        preds = logits if kind == "logits" else (1 / (1 + np.exp(-logits))).astype(np.float32)
        target = rng.integers(0, 2, n)
        if ignore_index is not None:
            target[rng.random(n) < 0.15] = ignore_index
        jpreds = preds if n_bins is None else jax_scores(preds, n_bins + 1)
        out.append((preds, target, jpreds))
    return out


def _multiclass_batches(seed: int, kind: str = "logits", ignore_index=None, classes: int = C):
    rng = np.random.default_rng(seed)
    out = []
    for n in SIZES:
        logits = (2 * rng.standard_normal((n, classes))).astype(np.float32)
        if kind == "probs":
            e = np.exp(logits - logits.max(1, keepdims=True))
            logits = (e / e.sum(1, keepdims=True)).astype(np.float32)
        target = rng.integers(0, classes, n)
        if ignore_index is not None:
            target[rng.random(n) < 0.15] = ignore_index
        out.append((logits, target, logits))
    return out


# ---------------------------------------------------------------- hinge loss


@pytest.mark.parametrize("kind", ["logits", "probs"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_hinge(kind, squared, ignore_index):
    three_levels(
        lambda: tc.BinaryHingeLoss(squared=squared, ignore_index=ignore_index, device="cpu"),
        lambda: jc.BinaryHingeLoss(squared=squared, ignore_index=ignore_index),
        _binary_batches(0, kind, ignore_index), atol=0.0, rtol=RTOL, float_state_rtol=RTOL,
    )


@pytest.mark.parametrize("kind", ["logits", "probs"])
@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_hinge(kind, mode, squared, ignore_index):
    kw = dict(squared=squared, multiclass_mode=mode, ignore_index=ignore_index)
    three_levels(
        lambda: tc.MulticlassHingeLoss(C, **kw, device="cpu"),
        lambda: jc.MulticlassHingeLoss(C, **kw),
        _multiclass_batches(1, kind, ignore_index), atol=0.0, rtol=RTOL, float_state_rtol=RTOL,
    )


def test_one_vs_all_on_two_classes():
    batches = _multiclass_batches(2, "logits", classes=2)
    three_levels(
        lambda: tc.MulticlassHingeLoss(2, multiclass_mode="one-vs-all", device="cpu"),
        lambda: jc.MulticlassHingeLoss(2, multiclass_mode="one-vs-all"),
        batches, atol=0.0, rtol=RTOL, float_state_rtol=RTOL,
    )
    assert tc.MulticlassHingeLoss(2, multiclass_mode="one-vs-all", device="cpu").measures.shape == (2,)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_hinge_functional_and_router(task, ignore_index):
    batches = (_binary_batches if task == "binary" else _multiclass_batches)(3, "logits", ignore_index)
    for preds, target, jpreds in batches:
        tp, tt, jp, jt = torch.from_numpy(preds), torch.from_numpy(target), jnp.asarray(jpreds), jnp.asarray(target)
        if task == "binary":
            got, want = tf.binary_hinge_loss(tp, tt, ignore_index=ignore_index), jf.binary_hinge_loss(jp, jt, ignore_index=ignore_index)
        else:
            got = tf.multiclass_hinge_loss(tp, tt, C, multiclass_mode="one-vs-all", ignore_index=ignore_index)
            want = jf.multiclass_hinge_loss(jp, jt, C, multiclass_mode="one-vs-all", ignore_index=ignore_index)
        assert_close(got, want, 0.0, RTOL, "functional")
        kw = dict(task=task, num_classes=C, ignore_index=ignore_index)
        assert_close(tf.hinge_loss(tp, tt, **kw), jf.hinge_loss(jp, jt, **kw), 0.0, RTOL, "router")
    assert isinstance(ttm.HingeLoss("binary", device="cpu"), tc.BinaryHingeLoss)
    assert isinstance(ttm.HingeLoss("multiclass", num_classes=3, device="cpu"), tc.MulticlassHingeLoss)
    with pytest.raises(ValueError, match="Invalid Task"):
        ttm.HingeLoss("multilabel", device="cpu")
    with pytest.raises(ValueError, match="`num_classes` is expected to be `int`"):
        tf.hinge_loss(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long), task="multiclass")


def test_hinge_argument_errors():
    for make in (lambda **k: tc.MulticlassHingeLoss(3, device="cpu", **k), lambda **k: jc.MulticlassHingeLoss(3, **k)):
        with pytest.raises(ValueError, match="multiclass_mode"):
            make(multiclass_mode="all")
        with pytest.raises(ValueError, match="squared"):
            make(squared=1)
    with pytest.raises(ValueError, match="floating"):
        tc.BinaryHingeLoss(device="cpu").update(torch.tensor([0, 1]), torch.tensor([0, 1]))


# ---------------------------------------------------------------- calibration error


@pytest.mark.parametrize("kind", ["logits", "probs"])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_calibration(kind, norm, ignore_index):
    three_levels(
        lambda: tc.BinaryCalibrationError(N_BINS, norm, ignore_index=ignore_index, device="cpu"),
        lambda: jc.BinaryCalibrationError(N_BINS, norm, ignore_index=ignore_index),
        _binary_batches(4, kind, ignore_index, n_bins=N_BINS), atol=CE_ATOL, float_state_atol=2.0**-23,
    )


@pytest.mark.parametrize("kind", ["logits", "probs"])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_calibration(kind, norm, ignore_index):
    three_levels(
        lambda: tc.MulticlassCalibrationError(C, N_BINS, norm, ignore_index=ignore_index, device="cpu"),
        lambda: jc.MulticlassCalibrationError(C, N_BINS, norm, ignore_index=ignore_index),
        _multiclass_batches(5, kind, ignore_index), atol=CE_ATOL, float_state_atol=2.0**-23,
    )


def test_confidence_of_one_lands_in_the_extra_bin():
    """n_bins + 1 bins: a confidence of exactly 1.0 (a saturated softmax) is binned past
    the last edge, as the JAX package bins it."""
    preds, target = [1.0, 1.0, 0.2, 0.9], [1, 1, 0, 1]
    got = tf.binary_calibration_error(torch.tensor(preds), torch.tensor(target), n_bins=4)
    want = jf.binary_calibration_error(jnp.asarray(preds), jnp.asarray(target), n_bins=4)
    assert_close(got, want, 1e-7)
    assert abs(float(got) - 0.075) < 1e-7
    from torchmetrics_tpu_torch.functional.classification.calibration_error import _binning_bucketize
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    acc, conf, prop = _binning_bucketize(torch.tensor(preds), torch.tensor(target, dtype=torch.float32), _adjust_threshold_arg(5))
    assert prop.shape == (5,) and prop[-1] == 0.5
    # a saturated softmax: every confidence is 1.0
    onehot = np.eye(C, dtype=np.float32)[np.arange(8) % C]
    labels = (np.arange(8) + (np.arange(8) % 3 == 0)) % C
    for norm in ("l1", "l2", "max"):
        assert_close(
            tf.multiclass_calibration_error(torch.from_numpy(onehot), torch.from_numpy(labels), C, norm=norm),
            jf.multiclass_calibration_error(jnp.asarray(onehot), jnp.asarray(labels), C, norm=norm),
            1e-7,
        )


def test_bin_edges_equal_the_jax_linspace():
    import jax

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    for n_bins in (1, 10, 15, 100):
        with jax.enable_x64(False):
            want = np.asarray(jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32))
        np.testing.assert_array_equal(_adjust_threshold_arg(n_bins + 1).numpy(), want)


def test_debias_and_the_functional_forms():
    from torchmetrics_tpu.functional.classification.calibration_error import _ce_compute as jax_ce
    from torchmetrics_tpu_torch.functional.classification.calibration_error import _ce_compute

    rng = np.random.default_rng(6)
    conf = rng.random(300).astype(np.float32)
    acc = (rng.random(300) < conf).astype(np.float32)
    for debias in (False, True):
        assert_close(
            _ce_compute(torch.from_numpy(conf), torch.from_numpy(acc), 15, "l2", debias=debias),
            jax_ce(jnp.asarray(conf), jnp.asarray(acc), 15, "l2", debias=debias), CE_ATOL,
        )
    for task in ("binary", "multiclass"):
        batches = (_binary_batches(7, "logits", -1, n_bins=N_BINS) if task == "binary" else _multiclass_batches(7, "logits", -1))
        for preds, target, jpreds in batches:
            kw = dict(task=task, n_bins=N_BINS, num_classes=C, ignore_index=-1)
            assert_close(
                tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), **kw),
                jf.calibration_error(jnp.asarray(jpreds), jnp.asarray(target), **kw), CE_ATOL,
            )
    assert isinstance(ttm.CalibrationError("multiclass", num_classes=3, device="cpu"), tc.MulticlassCalibrationError)
    with pytest.raises(ValueError, match="n_bins"):
        tc.BinaryCalibrationError(n_bins=0, device="cpu")
    with pytest.raises(ValueError, match="norm"):
        tc.MulticlassCalibrationError(3, norm="l3", device="cpu")


# ---------------------------------------------------------------- the engine


def _pairs(batches):
    return [((p, t), (jp, t)) for p, t, jp in batches]


@pytest.mark.parametrize(
    "name, make_port, make_ref, batches, refusal",
    [
        ("binary hinge", lambda: tc.BinaryHingeLoss(device="cpu"), lambda: jc.BinaryHingeLoss(),
         lambda: _binary_batches(8), "data-sized-output:_unique2"),
        ("binary hinge, no validation", lambda: tc.BinaryHingeLoss(validate_args=False, device="cpu"),
         lambda: jc.BinaryHingeLoss(validate_args=False), lambda: _binary_batches(8), "host-read:_local_scalar_dense"),
        ("multiclass hinge", lambda: tc.MulticlassHingeLoss(C, validate_args=False, device="cpu"),
         lambda: jc.MulticlassHingeLoss(C, validate_args=False), lambda: _multiclass_batches(8),
         "host-read:_local_scalar_dense"),
        ("multiclass calibration", lambda: tc.MulticlassCalibrationError(C, device="cpu"),
         lambda: jc.MulticlassCalibrationError(C), lambda: _multiclass_batches(8), ""),
        ("binary calibration", lambda: tc.BinaryCalibrationError(validate_args=False, device="cpu"),
         lambda: jc.BinaryCalibrationError(validate_args=False), lambda: _binary_batches(8), ""),
    ],
)
def test_engine_falls_back_where_the_jax_engine_does(name, make_port, make_ref, batches, refusal):
    """The hinge losses read the host to drop ignored rows (a refused first step, then
    ``uncompilable-signature``); the calibration errors hold cat lists (``list-state``)."""
    st = engine_split(make_port, make_ref, _pairs(batches()), refusal)
    assert st.dispatches == 0 and st.eager_fallbacks == len(SIZES), name


class _OneHotCounts(Metric):
    """Per-class label counts through ``to_onehot``."""

    full_state_update = False

    def __init__(self, num_classes: int, **kwargs) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.add_state("counts", torch.zeros(num_classes, dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, target: torch.Tensor) -> None:
        self.counts = self.counts + to_onehot(target, self.num_classes).sum(dim=0)

    def compute(self) -> torch.Tensor:
        return self.counts


def test_to_onehot_reads_nothing_back():
    """The repair: ``torch.nn.functional.one_hot`` checks its labels' range on the host,
    which demoted every update that called ``to_onehot`` to eager under the engine; the
    comparison one-hot is captured. Values, dtypes and layout as the JAX ``to_onehot``."""
    rng = np.random.default_rng(9)
    with engine_context(True):
        m = _OneHotCounts(5, device="cpu")
        for n in (16, 16, 16):
            m.update(torch.from_numpy(rng.integers(0, 5, n)))
    st = m._engine.stats
    assert st.eager_fallbacks == 0 and st.dispatches == 3, dict(st.fallback_reasons)
    for labels in (rng.integers(0, 5, 12), rng.integers(0, 5, (6, 3)), np.array([-1, 0, 4, 7])):
        for dtype in (np.int64, np.int32):
            x = labels.astype(dtype)
            for c in (None, 8):
                got, want = to_onehot(torch.from_numpy(x), c), np.asarray(jax_to_onehot(jnp.asarray(x), c))
                assert got.shape == want.shape and got.dtype == (torch.int64 if dtype == np.int64 else torch.int32)
                np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- state carried from the JAX package


@pytest.mark.parametrize("name", ["hinge", "calibration"])
def test_state_carried_from_jax(name):
    """Two batches in the JAX package, the state carried into the port (float sums,
    counts, cat lists), the stream finished there: equal to the JAX stream."""
    batches = _multiclass_batches(10, "probs", -1)
    if name == "hinge":
        make_port, make_ref = (lambda: tc.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", ignore_index=-1, device="cpu"),
                               lambda: jc.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", ignore_index=-1))
    else:
        make_port, make_ref = (lambda: tc.MulticlassCalibrationError(C, ignore_index=-1, device="cpu"),
                               lambda: jc.MulticlassCalibrationError(C, ignore_index=-1))
    ref, port = make_ref(), make_port()
    ref.persistent(True)
    for p, t, _ in batches[:2]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    for p, t, _ in batches[2:]:
        ref.update(jnp.asarray(p), jnp.asarray(t))
        port.update(torch.from_numpy(p), torch.from_numpy(t))
    assert_states(port, ref, float_rtol=RTOL)
    assert_close(port.compute(), ref.compute(), CE_ATOL, RTOL)
