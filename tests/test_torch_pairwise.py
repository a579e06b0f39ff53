"""The pairwise functionals and the slice's small modules: the port (on the CPU) against the JAX package.

The five pairwise functionals, each with and without ``y``, at every ``zero_diagonal``
and reduction, and their input errors; Manhattan and Minkowski also over row blocks
that split ``x`` unevenly (the port bounds each broadcast temporary, where the JAX
package builds one ``(N, M, d)``). Then ``utilities/distributed.py``,
``utilities/imports.py``, ``__version__``, and the names the port still lacks from the
JAX package's root and functional ``__all__``.

Tolerances: float32 matrices and their reductions within relative 1e-5 (absolute 1e-5
for cosine values near 0); Euclidean against the JAX package's x64 result (the tests'
setting: both compute the norm algebra in float64 and round once) within relative 1e-6
and absolute 1e-6 where a distance cancels to ~0.
"""

from __future__ import annotations

import doctest
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.functional as jF
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional as tF
from tests.torch_parity import assert_close
from torchmetrics_tpu.utilities import distributed as jdist
from torchmetrics_tpu_torch.functional.pairwise import helpers
from torchmetrics_tpu_torch.utilities import distributed as tdist
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

FUNCTIONS = (
    "pairwise_linear_similarity",
    "pairwise_cosine_similarity",
    "pairwise_euclidean_distance",
    "pairwise_manhattan_distance",
    "pairwise_minkowski_distance",
)
RTOL = 1e-5
ATOL = {"pairwise_cosine_similarity": 1e-5, "pairwise_euclidean_distance": 1e-6}


def _inputs(seed: int, n: int = 13, m: int = 9, d: int = 6):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.0, (n, d)).astype(np.float32)
    y = rng.normal(0.0, 2.0, (m, d)).astype(np.float32)
    x[3] = 0.0  # a zero row: the cosine keeps it zero
    return x, y


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("with_y", [False, True])
def test_pairwise(fn, with_y):
    x, y = _inputs(0)
    extra = {"exponent": 3} if fn.endswith("minkowski_distance") else {}
    rtol = 1e-6 if fn == "pairwise_euclidean_distance" else RTOL
    for zero_diagonal in (None, True, False):
        for reduction in (None, "mean", "sum", "none"):
            kwargs = dict(reduction=reduction, zero_diagonal=zero_diagonal, **extra)
            got = getattr(tF, fn)(torch.from_numpy(x), torch.from_numpy(y) if with_y else None, **kwargs)
            want = getattr(jF, fn)(jnp.asarray(x), jnp.asarray(y) if with_y else None, **kwargs)
            assert got.dtype == torch.float32
            assert_close(got, want, ATOL.get(fn, 0.0), rtol, f"{fn} y={with_y} {kwargs}")


@pytest.mark.parametrize("exponent", [1, 2.5, 4])
def test_minkowski_exponents(exponent):
    x, y = _inputs(1)
    got = tF.pairwise_minkowski_distance(torch.from_numpy(x), torch.from_numpy(y), exponent=exponent)
    want = jF.pairwise_minkowski_distance(jnp.asarray(x), jnp.asarray(y), exponent=exponent)
    assert_close(got, want, 0.0, RTOL, f"p={exponent}")


@pytest.mark.parametrize("fn", ["pairwise_manhattan_distance", "pairwise_minkowski_distance"])
def test_row_blocks_split_unevenly(fn, monkeypatch):
    """Blocks of 3 rows over 13 (3, 3, 3, 3, 1): each block's temporary is bounded, and
    every value equals the one-block result and the JAX package's."""
    x, y = _inputs(2)
    whole = getattr(tF, fn)(torch.from_numpy(x), torch.from_numpy(y))
    per_row = y.shape[0] * y.shape[1] * 4
    monkeypatch.setattr(helpers, "_BLOCK_BYTES", 3 * per_row + per_row // 2)
    calls = []
    real_cat = torch.cat
    monkeypatch.setattr(helpers.torch, "cat", lambda parts: calls.append([p.shape[0] for p in parts]) or real_cat(parts))
    got = getattr(tF, fn)(torch.from_numpy(x), torch.from_numpy(y))
    assert calls == [[3, 3, 3, 3, 1]]
    assert torch.equal(got, whole)
    assert_close(got, getattr(jF, fn)(jnp.asarray(x), jnp.asarray(y)), 0.0, RTOL, fn)


def test_euclidean_is_float64_inside():
    """Rows far from the origin and close to each other: a float32 norm algebra cancels
    to garbage, the float64 one keeps the distances (JAX under x64 does the same)."""
    rng = np.random.default_rng(4)
    x = (1000.0 + rng.random((6, 4))).astype(np.float32)
    got = tF.pairwise_euclidean_distance(torch.from_numpy(x))
    want = jF.pairwise_euclidean_distance(jnp.asarray(x))
    assert_close(got, want, 1e-6, 1e-6)
    exact = np.sqrt(((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-4, atol=1e-3)


def test_input_errors():
    for fn in FUNCTIONS:
        with pytest.raises(ValueError, match="2D tensor"):
            getattr(tF, fn)(torch.ones(3))
        with pytest.raises(ValueError, match="same as the last dimension"):
            getattr(tF, fn)(torch.ones(3, 2), torch.ones(3, 4))
        with pytest.raises(ValueError, match="reduction"):
            getattr(tF, fn)(torch.ones(3, 2), reduction="max")
    for exponent in (0.5, "2"):
        with pytest.raises(TorchMetricsUserError, match="greater than or equal to 1"):
            tF.pairwise_minkowski_distance(torch.ones(3, 2), exponent=exponent)


@pytest.mark.parametrize("module", [f"torchmetrics_tpu_torch.functional.pairwise.{m[9:].split('_')[0]}" for m in FUNCTIONS])
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed


# ---------------------------------------------------------------- utilities, version, names


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none", None])
def test_reduce(reduction):
    x = np.random.default_rng(5).random((4, 3)).astype(np.float32)
    assert_close(tdist.reduce(torch.from_numpy(x), reduction), jdist.reduce(jnp.asarray(x), reduction), 1e-7, 1e-6)


@pytest.mark.parametrize("class_reduction", ["micro", "macro", "weighted", "none", None])
def test_class_reduce(class_reduction):
    num = np.array([3.0, 0.0, 5.0, 1.0], dtype=np.float32)
    denom = np.array([4.0, 0.0, 8.0, 2.0], dtype=np.float32)  # a class of 0 / 0 counts as 0
    weights = np.array([4.0, 0.0, 8.0, 2.0], dtype=np.float32)
    got = tdist.class_reduce(*(torch.from_numpy(a) for a in (num, denom, weights)), class_reduction)
    want = jdist.class_reduce(*(jnp.asarray(a) for a in (num, denom, weights)), class_reduction)
    assert_close(got, want, 1e-7, 1e-6, str(class_reduction))


def test_reduce_errors_and_gather_reexport():
    with pytest.raises(ValueError, match="unknown"):
        tdist.reduce(torch.ones(2), "max")
    with pytest.raises(ValueError, match="unknown"):
        tdist.class_reduce(torch.ones(2), torch.ones(2), torch.ones(2), "max")
    x = torch.arange(3)
    assert tdist.gather_all_tensors(x)[0] is x  # no process group: the tensor itself


_FLAGS = """
import torchmetrics_tpu.utilities.imports as jax_imports
import torchmetrics_tpu_torch.utilities.imports as imports
names = [n for n in vars(jax_imports) if n.endswith("_AVAILABLE") and n not in ("_XLA_AVAILABLE", "_JAX_AVAILABLE", "_FLAX_AVAILABLE")]
different = [n for n in names if getattr(imports, n) != getattr(jax_imports, n)]
assert not different and imports._TORCH_AVAILABLE and not hasattr(imports, "_XLA_AVAILABLE"), different
print("flags", len(names))
"""


def test_import_flags_and_version():
    """The flags agree with the JAX package's where both have one. They are read in a
    fresh interpreter: each module freezes its flags when first imported, and other
    tests put package shims on ``sys.path`` in between."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _FLAGS], cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "flags" in res.stdout, res.stderr
    assert ttm.__version__ == jtm.__version__ == "1.0.0rc0"
    assert ttm.functional is tF


# what the port still lacks: nothing, since the serving layer's six root names came in
ROOT_MISSING: set = set()
FUNCTIONAL_MISSING: set = set()


def test_names_still_missing():
    """The port's root has every name of the JAX root (the serving layer's six last),
    and its functional package every JAX functional name; every name the port exports
    resolves."""
    assert set(jtm.__all__) - set(ttm.__all__) == ROOT_MISSING and len(ROOT_MISSING) == 0
    assert set(jF.__all__) - set(tF.__all__) == FUNCTIONAL_MISSING and len(FUNCTIONAL_MISSING) == 0
    for pkg in (ttm, tF):
        for name in pkg.__all__:
            assert getattr(pkg, name) is not None, name
