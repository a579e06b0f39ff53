"""Flax-variable <-> npz serialization for converted backbone weights (counterpart of
``torchmetrics_tpu/models/serialization.py``).

The format is the JAX package's: one ``.npz`` whose keys are ``/``-joined paths into the
flax variables tree (``params/Conv_0/kernel``), so a file written by the JAX package's
``scripts/convert_backbones.py`` loads here and the reverse. The tree's leaves are numpy
arrays; a trunk's ``state_dict_from_flax`` turns such a tree into its state dict.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def save_variables_npz(path: str, variables: Dict[str, Any]) -> int:
    """Write a variables tree to ``path``; returns the total parameter count."""
    flat = _flatten(variables)
    np.savez(path, **flat)
    return int(sum(v.size for v in flat.values()))


def load_variables_npz(path: str) -> Dict[str, Any]:
    """Load a converted-backbone npz back into the nested variables tree of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def count_params(variables: Dict[str, Any]) -> int:
    """Total leaf-array element count: the cheap integrity check for a conversion."""
    return int(sum(v.size for v in _flatten(variables).values()))
