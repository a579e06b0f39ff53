"""The health sentinel of the port (``torchmetrics_tpu_torch/diag/sentinel.py``) against the
JAX package's, bit for bit.

Each planted case (a NaN into a float sum, ±Inf with the default exemption, the
half-range overflow of an int32 count, a negative count, a poisoned batch under
quarantine, an absorbed increment under compensation) runs the same numpy batches
through both packages in four modes: eagerly, under the engine, in the fused collection
step and under the scan queue at K = 8. ``read_sentinel`` must give the same bitmask in
every mode; the engine's must equal its bitmask in the other engine modes.
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu_torch as ttm
from torchmetrics_tpu.diag import sentinel as jsent
from torchmetrics_tpu.engine import engine_context as j_engine
from torchmetrics_tpu.engine import numerics as jnum
from torchmetrics_tpu.engine import scan as jscan
from torchmetrics_tpu.engine import txn as jtxn
from torchmetrics_tpu.metric import Metric as JMetric
from torchmetrics_tpu_torch.diag import sentinel as tsent
from torchmetrics_tpu_torch.engine import engine_context as t_engine
from torchmetrics_tpu_torch.engine import numerics as tnum
from torchmetrics_tpu_torch.engine import scan as tscan
from torchmetrics_tpu_torch.engine import txn as ttxn
from torchmetrics_tpu_torch.metric import Metric as TMetric


class JFloatSum(JMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


class TFloatSum(TMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, x):
        self.total = self.total + x.sum()

    def compute(self):
        return self.total


class JIntCount(JMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("count", jnp.zeros((), jnp.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.count = self.count + x.sum().astype(jnp.int32)

    def compute(self):
        return self.count


class TIntCount(TMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, x):
        self.count = self.count + x.sum().to(torch.int32)

    def compute(self):
        return self.count


def _f32(*rows):
    return [np.asarray(r, dtype=np.float32) for r in rows]


def _i32(*rows):
    return [np.asarray(r, dtype=np.int32) for r in rows]


def _sum_metric(jax_side: bool):
    # the aggregators declare their update additive: compensation applies to them
    return jtm.SumMetric(nan_strategy=0.0) if jax_side else ttm.SumMetric(nan_strategy=0.0, device="cpu")


def _min_metric(jax_side: bool):
    # MinMetric's default is +Inf: the default exemption keeps pos_inf off
    return jtm.MinMetric(nan_strategy=0.0) if jax_side else ttm.MinMetric(nan_strategy=0.0, device="cpu")


def _pair(jcls, tcls):
    return lambda jax_side: jcls() if jax_side else tcls()


# case -> (metric factory, batches, knobs, the bit the engine routes must raise)
_CLEAN = [1.0, 2.0, 3.0, 4.0]
CASES = {
    "nan": (_pair(JFloatSum, TFloatSum), _f32(_CLEAN, [1.0, np.nan, 0.0, 0.0], _CLEAN, _CLEAN), {}, tsent.FLAG_NAN),
    "pos_inf": (_pair(JFloatSum, TFloatSum), _f32(_CLEAN, [np.inf, 0.0, 0.0, 0.0], _CLEAN), {}, tsent.FLAG_POS_INF),
    "neg_inf": (_pair(JFloatSum, TFloatSum), _f32(_CLEAN, [-np.inf, 0.0, 0.0, 0.0]), {}, tsent.FLAG_NEG_INF),
    "overflow": (_pair(JIntCount, TIntCount), _i32([2**29, 2**29, 1, 0], [1, 1, 1, 1]), {}, tsent.FLAG_OVERFLOW),
    "negative": (
        _pair(JIntCount, TIntCount), _i32([1, 1, 1, 1], [-9, 0, 0, 0], [1, 1, 1, 1]), {}, tsent.FLAG_NEGATIVE_COUNT,
    ),
    "poisoned": (
        _pair(JFloatSum, TFloatSum), _f32(_CLEAN, [1.0, np.nan, 0.0, 0.0], _CLEAN), {"quarantine": True},
        tsent.FLAG_INPUT_POISONED,
    ),
    "precision": (
        _sum_metric, _f32([2.0**25, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]),
        {"compensated": True}, tsent.FLAG_PRECISION_LOSS,
    ),
    "inf_default": (_min_metric, _f32(_CLEAN, _CLEAN), {}, 0),
}

MODES = ("eager", "engine", "fused", "scan")


@contextlib.contextmanager
def _knobs(knobs: dict, jax_side: bool):
    with contextlib.ExitStack() as stack:
        if knobs.get("quarantine"):
            stack.enter_context((jtxn if jax_side else ttxn).quarantine_context(True))
        if knobs.get("compensated"):
            stack.enter_context((jnum if jax_side else tnum).compensated_context(True))
        yield


def _states(m) -> dict:
    return {k: np.asarray(getattr(m, k)).copy() for k in m._defaults}


def _run(case: str, mode: str, jax_side: bool) -> tuple:
    """``(flags, states)`` of the planted metric after its batches and a ``compute``."""
    make, batches, knobs, _ = CASES[case]
    sentinel = jsent if jax_side else tsent
    engine = j_engine if jax_side else t_engine
    scan = jscan if jax_side else tscan
    to = jnp.asarray if jax_side else torch.from_numpy
    with contextlib.ExitStack() as stack:
        stack.enter_context(sentinel.sentinel_context(True))
        stack.enter_context(engine(mode != "eager"))
        stack.enter_context(_knobs(knobs, jax_side))
        if mode == "scan":
            stack.enter_context(scan.scan_context(8))
        if mode == "fused":
            # a second, always-clean float sum beside the planted member: two owners fuse
            coll = jtm.MetricCollection if jax_side else ttm.MetricCollection
            planted = make(jax_side)
            other = (JFloatSum if jax_side else TFloatSum)()
            mc = coll({"a": planted, "b": other}, compute_groups=False)
            for x in batches:
                mc.update(to(x))
            mc.compute()
            return sentinel.read_sentinel(planted)["flags"], _states(planted)
        m = make(jax_side)
        for x in batches:
            m.update(to(x))
        m.compute()
        return sentinel.read_sentinel(m)["flags"], _states(m)


def test_bits_and_names_are_the_jax_layout():
    assert tsent.SENTINEL_BITS == jsent.SENTINEL_BITS
    assert tsent.STATE_KEY == jsent.STATE_KEY and tsent.ATTR == jsent.ATTR


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sentinel_equals_jax(case, mode):
    got, states = _run(case, mode, jax_side=False)
    want, _ = _run(case, mode, jax_side=True)
    assert got == want, f"{case}/{mode}: port {got:#x}, JAX {want:#x}"
    if mode != "eager":
        # every engine route folds the same bit in, and leaves the states eager leaves
        assert got & CASES[case][3] == CASES[case][3], (case, mode, got)
        _, eager = _run(case, "eager", jax_side=False)
        for k, v in eager.items():
            np.testing.assert_array_equal(states[k], v, err_msg=f"{case}/{mode}: {k}")


def test_sentinel_is_sticky_and_reset_zeroes_it_in_place():
    with tsent.sentinel_context(True), t_engine(True):
        m = TFloatSum()
        m.update(torch.tensor([np.nan], dtype=torch.float32))
        for _ in range(3):
            m.update(torch.ones(1))
        flags = m._sentinel_flags
        assert tsent.read_sentinel(m)["bits"] == ["nan"]
        m.reset()
        assert m._sentinel_flags is flags and tsent.read_sentinel(m)["flags"] == 0
        m.update(torch.ones(1))
        assert tsent.read_sentinel(m)["flags"] == 0


def test_engine_bitmask_is_a_static_buffer_written_in_place():
    from torchmetrics_tpu_torch.engine.compiled import is_static

    with tsent.sentinel_context(True), t_engine(True):
        m = TFloatSum()
        m.update(torch.ones(4))
        m.update(torch.ones(4))
        buf = m._sentinel_flags
        assert is_static(buf)
        m.update(torch.tensor([np.inf, 0, 0, 0], dtype=torch.float32))
        assert m._sentinel_flags is buf and tsent.read_sentinel(m)["bits"] == ["pos_inf"]


def test_cached_compute_folds_the_value_checks():
    """A 0/0 compute raises ``nan`` through the cached compute graph in both packages."""

    class JRatio(JFloatSum):
        def compute(self):
            return self.total / self.total

    class TRatio(TFloatSum):
        def compute(self):
            return self.total / self.total

    out = []
    for jax_side, cls, to in ((True, JRatio, jnp.asarray), (False, TRatio, torch.from_numpy)):
        sentinel, engine = (jsent, j_engine) if jax_side else (tsent, t_engine)
        with sentinel.sentinel_context(True), engine(True):
            m = cls()
            m.update(to(np.zeros(4, dtype=np.float32)))
            m.update(to(np.zeros(4, dtype=np.float32)))
            m.compute()
            out.append(sentinel.read_sentinel(m)["flags"])
    assert out[0] == out[1] == tsent.FLAG_NAN


def test_report_rows_match_jax_shape():
    tsent.reset_sentinels()  # the registry is process-wide: drop earlier tests' metrics
    with tsent.sentinel_context(True), t_engine(True):
        a, b = TFloatSum(), TFloatSum()
        a.update(torch.tensor([np.nan], dtype=torch.float32))
        b.update(torch.ones(1))
        rows = [r for r in tsent.sentinel_report() if r["owner"] == "TFloatSum"]
    assert rows == [{"owner": "TFloatSum", "flags": 1, "bits": ["nan"], "instances": 2}]


class _Holder:
    """The two attributes ``update_flags`` reads off a metric."""

    def __init__(self, reductions: dict, inf_default: dict) -> None:
        self._reductions = reductions
        self._sentinel_inf_default = inf_default


@pytest.mark.parametrize("seed", range(6))
def test_update_flags_equals_jax_on_mixed_states(seed):
    """The batched fold against the JAX ``update_flags`` on a mix of states: floats with
    planted NaN / ±Inf (one Inf-exempt), complex, signed counts near half their range or
    negative, unsigned, an empty one."""
    from torchmetrics_tpu.utilities import data as jdata
    from torchmetrics_tpu_torch.utilities import data as tdata

    rng = np.random.default_rng(seed)
    plant = lambda a, v: (a.reshape(-1).__setitem__(int(rng.integers(0, a.size)), v), a)[1]  # noqa: E731
    f32 = rng.normal(size=(5, 3)).astype(np.float32)
    f64 = rng.normal(size=(7,))
    states = {
        "a": plant(f32, [np.nan, np.inf, -np.inf, 1.0][seed % 4]),
        "b": plant(f64, [np.inf, 2.0, -np.inf, np.nan][seed % 4]),
        "exempt": np.array([np.inf, -np.inf, 0.0], np.float32),
        "c": (rng.normal(size=(4,)) + 1j * rng.normal(size=(4,))).astype(np.complex64),
        "n32": rng.integers(0, 100, (6,)).astype(np.int32),
        "n64": rng.integers(0, 100, (3,)).astype(np.int64),
        "u8": rng.integers(0, 100, (5,)).astype(np.uint8),
        "empty": np.zeros((0,), np.int32),
        "mx": rng.integers(-5, 5, (4,)).astype(np.int32),
    }
    if seed % 3 == 0:
        states["n32"][1] = 2**30 + 7
    if seed % 3 == 1:
        states["n64"][0] = -3
    if seed % 2:
        states["u8"][2] = 200
        states["c"][0] = complex(np.nan, 0.0)
    reds_j = {k: jdata.dim_zero_sum for k in states}
    reds_t = {k: tdata.dim_zero_sum for k in states}
    reds_j["mx"], reds_t["mx"] = jdata.dim_zero_max, tdata.dim_zero_max  # negative values allowed
    exempt = {k: k == "exempt" for k in states}
    want = int(jsent.update_flags(jnp.int32(0), {k: jnp.asarray(v) for k, v in states.items()}, _Holder(reds_j, exempt)))
    got = int(tsent.update_flags(torch.zeros((), dtype=torch.int32), {k: torch.from_numpy(v) for k, v in states.items()},
                                 _Holder(reds_t, exempt)))
    assert got == want, (seed, got, want)
