"""Arithmetic on the port's metrics (``CompositionalMetric``) against the JAX package's.

Every operator overload, binary and unary, metric with metric, metric with a number
and a number with a metric (the reflected forms), is held against the JAX
``CompositionalMetric`` on the same inputs: the epoch ``compute``, each batch's
``forward`` through a composite, and the fold of two replicas of the operands. Also
``hash`` and ``==`` (which composes), pickling, and the casts that are no-ops.
"""

from __future__ import annotations

import copy
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch as tm
from tests.torch_parity import assert_close
from torchmetrics_tpu.metric import CompositionalMetric as JaxCompositionalMetric
from torchmetrics_tpu_torch import CompositionalMetric

ATOL = 1e-6
C = 4
_RNG = np.random.default_rng(3)
_PREDS = [_RNG.integers(0, C, 24) for _ in range(3)]
_TARGET = [_RNG.integers(0, C, 24) for _ in range(3)]


def _mean(values, package):
    m = package.MeanMetric(device="cpu") if package is tm else package.MeanMetric()
    m.update(torch.tensor(values) if package is tm else jnp.asarray(values))
    return m


def _cat(values, package):
    m = package.CatMetric(device="cpu") if package is tm else package.CatMetric()
    m.update(torch.tensor(values) if package is tm else jnp.asarray(values))
    return m


def _stat_scores(package):
    """An integer-valued metric (tp, fp, tn, fn, support) for the bitwise operators."""
    if package is tm:
        m = tm.MulticlassStatScores(num_classes=C, average="micro", device="cpu")
        m.update(torch.from_numpy(_PREDS[0]), torch.from_numpy(_TARGET[0]))
    else:
        m = jc.MulticlassStatScores(num_classes=C, average="micro")
        m.update(jnp.asarray(_PREDS[0]), jnp.asarray(_TARGET[0]))
    return m


def _check(port, ref):
    assert isinstance(port, CompositionalMetric) and isinstance(ref, JaxCompositionalMetric)
    got, want = port.compute(), ref.compute()
    assert got.shape == tuple(np.shape(want))
    assert_close(got, np.asarray(want).astype(np.asarray(got).dtype) if got.dtype == torch.bool else want, ATOL)


_ARITHMETIC = [operator.add, operator.sub, operator.mul, operator.truediv, operator.floordiv, operator.mod, operator.pow]
_COMPARISON = [operator.eq, operator.ne, operator.lt, operator.le, operator.gt, operator.ge]
_BITWISE = [operator.and_, operator.or_, operator.xor]


@pytest.mark.parametrize("op", _ARITHMETIC + _COMPARISON, ids=lambda o: o.__name__)
def test_metric_op_metric(op):
    _check(op(_mean([2.0, 4.5], tm), _mean([1.0, 3.0], tm)), op(_mean([2.0, 4.5], jtm), _mean([1.0, 3.0], jtm)))


@pytest.mark.parametrize("scalar", [2, 0.5, -3.0], ids=str)
@pytest.mark.parametrize("op", _ARITHMETIC + _COMPARISON, ids=lambda o: o.__name__)
def test_metric_op_scalar_and_reflected(op, scalar):
    _check(op(_mean([2.0, 4.5], tm), scalar), op(_mean([2.0, 4.5], jtm), scalar))
    _check(op(scalar, _mean([2.0, 4.5], tm)), op(scalar, _mean([2.0, 4.5], jtm)))


@pytest.mark.parametrize("op", _BITWISE, ids=lambda o: o.__name__)
def test_bitwise_operators(op):
    _check(op(_stat_scores(tm), _stat_scores(tm)), op(_stat_scores(jtm), _stat_scores(jtm)))
    _check(op(_stat_scores(tm), 6), op(_stat_scores(jtm), 6))
    _check(op(6, _stat_scores(tm)), op(6, _stat_scores(jtm)))


_MEAN = lambda p: _mean([-2.0, -4.5], p)  # noqa: E731
_CAT = lambda p: _cat([-1.0, 2.5, -3.0], p)  # noqa: E731


@pytest.mark.parametrize(
    ("op", "make"),
    [
        (abs, _MEAN),
        (abs, _CAT),
        (operator.neg, _MEAN),
        (operator.neg, _CAT),
        (operator.pos, _MEAN),
        (operator.pos, _CAT),
        (lambda m: m[1], _CAT),
        (lambda m: m[-1], _CAT),
    ],
    ids=["abs-mean", "abs-cat", "neg-mean", "neg-cat", "pos-mean", "pos-cat", "getitem-1", "getitem-last"],
)
def test_unary_operators(op, make):
    _check(op(make(tm)), op(make(jtm)))


def test_invert_and_matmul():
    _check(~_stat_scores(tm), ~_stat_scores(jtm))
    _check(_cat([1.0, 2.0, 3.0], tm) @ _cat([0.5, -1.0, 2.0], tm), _cat([1.0, 2.0, 3.0], jtm) @ _cat([0.5, -1.0, 2.0], jtm))
    vec = np.array([2.0, 0.0, 1.0], dtype=np.float32)
    _check(_cat([1.0, 2.0, 3.0], tm).__rmatmul__(vec), _cat([1.0, 2.0, 3.0], jtm).__rmatmul__(vec))
    _check(_cat([1.0, 2.0, 3.0], tm) @ vec, _cat([1.0, 2.0, 3.0], jtm) @ vec)


def test_forward_update_and_merge_through_a_composite():
    """``1 - accuracy`` over batches: each ``forward`` value, the epoch value, the
    operand's fold of two replicas, and the operand's own value."""
    port_acc, ref_acc = tm.MulticlassAccuracy(num_classes=C, device="cpu"), jc.MulticlassAccuracy(num_classes=C)
    port, ref = 1 - port_acc, 1 - ref_acc
    for p, t in zip(_PREDS, _TARGET):
        assert_close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)), ATOL)
    assert_close(port.compute(), ref.compute(), ATOL)
    assert_close(port.compute(), 1 - port_acc.compute(), 0.0)
    halves = []
    for package in (tm, jtm):
        a = package.MulticlassAccuracy(num_classes=C, device="cpu") if package is tm else jc.MulticlassAccuracy(num_classes=C)
        b = copy.deepcopy(a)
        comp = a * 2 + b
        cast = torch.from_numpy if package is tm else jnp.asarray
        for i, (p, t) in enumerate(zip(_PREDS, _TARGET)):
            comp.update(cast(p), cast(t)) if i % 2 else a.update(cast(p), cast(t))
        a.merge_state(b)
        halves.append(comp.compute())
    assert_close(halves[0], halves[1], ATOL)
    port.reset()
    assert port_acc.update_count == 0


def test_composite_of_a_cpu_metric_runs_on_the_cpu():
    comp = tm.SumMetric(device="cpu") + 1
    assert comp.device.type == "cpu" and comp.metric_b.device.type == "cpu"
    comp.update(torch.tensor([1.0, 2.0]))
    assert float(comp.compute()) == 4.0


def test_hash_and_eq_semantics():
    a, b = tm.SumMetric(device="cpu"), tm.SumMetric(device="cpu")
    assert isinstance(hash(a), int) and hash(a) != hash(b)
    before = hash(a)
    a.update(torch.tensor([1.0]))  # the state is replaced: the hash follows it, as in the JAX package
    assert hash(a) != before
    ja = jtm.SumMetric()
    j_before = hash(ja)
    ja.update(jnp.asarray([1.0]))
    assert hash(ja) != j_before
    eq = a == b
    assert isinstance(eq, CompositionalMetric) and bool(eq)  # truthy: `m in [x]` matches any metric
    assert {id(a): "a", id(b): "b"}[id(b)] == "b"
    assert float((a != b).compute()) == 1.0


def test_pickle_and_deepcopy():
    a, b = tm.MeanMetric(device="cpu"), tm.MeanMetric(device="cpu")
    comp = a + b
    comp.update(torch.tensor([1.0, 3.0]))
    for clone in (pickle.loads(pickle.dumps(comp)), copy.deepcopy(comp)):
        assert float(clone.compute()) == float(comp.compute()) == 4.0
        assert clone.metric_a is not a
    assert a.__getnewargs__() == ("value", "weight") == jtm.MeanMetric().__getnewargs__()
    restored = pickle.loads(pickle.dumps(a))
    assert float(restored.compute()) == 2.0 and restored._defaults.keys() == a._defaults.keys()
    with pytest.raises(TypeError):
        iter(a)


def test_casts_are_no_ops_and_set_dtype_casts():
    port, ref = tm.SumMetric(device="cpu"), jtm.SumMetric()
    port.update(torch.tensor([2.0]))
    ref.update(jnp.asarray([2.0]))
    for cast in ("half", "double", "float"):
        assert getattr(port, cast)() is port and port.value.dtype == torch.float32
        getattr(ref, cast)()
    assert port.type(torch.float64) is port and port.value.dtype == torch.float32
    assert str(ref.value.dtype) == "float32"
    port.set_dtype(torch.float16)
    ref.set_dtype(jnp.float16)
    assert port.value.dtype == port._defaults["value"].dtype == torch.float16
    assert str(ref.value.dtype) == "float16"
    assert_close(port.compute(), ref.compute(), 0.0)
    counts = tm.MulticlassStatScores(num_classes=C, device="cpu").set_dtype(torch.float64)
    assert all(getattr(counts, k).dtype == torch.int32 for k in counts._defaults)  # integer states stay
