"""Rank-zero-gated printing helpers (counterpart of ``torchmetrics_tpu/utilities/prints.py``).

The rank comes from ``LOCAL_RANK`` when a launcher sets it, else from
``torch.distributed`` when a process group is up, else 0.
"""

from __future__ import annotations

import os
import warnings
from functools import wraps
from typing import Any, Callable

import torch.distributed as dist


def _get_rank() -> int:
    rank = os.environ.get("LOCAL_RANK")
    if rank is not None:
        return int(rank)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on global rank zero."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, category: type = UserWarning, stacklevel: int = 5, **kwargs: Any) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel, **kwargs)


def _deprecated_root_import_class(name: str, domain: str) -> None:
    """Warn that importing a domain metric class from the package root is deprecated."""
    rank_zero_warn(
        f"`torchmetrics_tpu_torch.{name}` was deprecated and will be removed in 2.0."
        f" Import `torchmetrics_tpu_torch.{domain}.{name}` instead.",
        DeprecationWarning,
    )


def _deprecated_root_import_func(name: str, domain: str) -> None:
    """Warn that importing a domain functional from ``functional``'s root is deprecated."""
    rank_zero_warn(
        f"`torchmetrics_tpu_torch.functional.{name}` was deprecated and will be removed in 2.0."
        f" Import `torchmetrics_tpu_torch.functional.{domain}.{name}` instead.",
        DeprecationWarning,
    )
