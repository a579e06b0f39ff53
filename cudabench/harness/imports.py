"""The check that nothing in the process loaded JAX or the JAX package.

Names are compared whole, by the part before the first dot, so the port
``torchmetrics_tpu_torch`` passes and ``torchmetrics_tpu`` does not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "torchmetrics_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The top-level names among ``names`` (default: ``sys.modules``) that are forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
