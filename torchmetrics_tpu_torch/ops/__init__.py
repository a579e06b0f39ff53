"""The port's hand-written CUDA kernels, each beside its plain PyTorch version.

``stat_counts`` (K1) and ``multi_threshold`` (K2): each wrapper launches its kernel for
CUDA tensors and runs the plain version for CPU tensors, and counts its launches in
the module's ``LAUNCHES``. The kernels build at first use (``_build``).

A replay of a captured CUDA graph launches the kernels the graph holds without calling
their wrappers. The update engine (``engine/compiled.py``) therefore reads the counts
around a capture (``launch_counts``), puts them back (``set_launch_counts``: a capture
records, it does not launch) and adds the recorded launches on every replay
(``add_launches``), so ``LAUNCHES`` counts what ran on the card either way.
"""

from __future__ import annotations

from typing import Dict

from torchmetrics_tpu_torch.ops import multi_threshold, stat_counts

_KERNELS = {"stat_counts": stat_counts, "multi_threshold": multi_threshold}


def launch_counts() -> Dict[str, int]:
    """Each kernel's ``LAUNCHES``, by kernel module name."""
    return {name: module.LAUNCHES for name, module in _KERNELS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Set each kernel's ``LAUNCHES`` (``chip_smoke.py`` zeroes them before a path)."""
    for name, value in counts.items():
        _KERNELS[name].LAUNCHES = value


def add_launches(counts: Dict[str, int]) -> None:
    """Add launches that ran without their wrapper (a graph replay)."""
    for name, value in counts.items():
        if value:
            _KERNELS[name].LAUNCHES += value
