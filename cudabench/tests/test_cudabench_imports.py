"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole top-level
name, and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from cudabench.harness import spec
from cudabench.harness.imports import FORBIDDEN, forbidden_modules

PROGRAM = "torchmetrics_tpu_torch"


@pytest.mark.parametrize(
    "names, found",
    [
        (["torchmetrics_tpu_torch", "torchmetrics_tpu_torch.engine.compiled"], []),
        (["torchmetrics_tpu", "torch"], ["torchmetrics_tpu"]),
        (["torchmetrics_tpu.ops.stat_counts"], ["torchmetrics_tpu"]),
        (["jax._src.core", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
        (["jaxtyping", "flaxen", "torchmetrics_tpu_x"], []),
    ],
)
def test_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def _imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in spec.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imported_top_levels(path) <= {"__future__", "typing", "numpy", "torch", "math"}
    assert PROGRAM not in path.read_text()


def test_a_run_loads_none_of_them():
    """Every piece of every cell imported, the metrics built, and a small run made, in a
    fresh process: nothing forbidden in ``sys.modules`` afterwards."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r})\n"
        f"sys.path.insert(0, {str(spec.BENCH_DIR / 'tests')!r})\n"
        "from _small import small_cell, CELLS\n"
        "from cudabench.harness.cell import run_cell\n"
        "from cudabench.harness.imports import forbidden_modules\n"
        "for name in CELLS:\n"
        "    cell, sizes = small_cell(name)\n"
        "    run_cell(cell, 1, 0.05, False, torch.device('cpu'), time.perf_counter(), sizes=sizes)\n"
        "print(forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
