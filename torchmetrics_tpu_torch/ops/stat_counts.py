"""Fused logits -> per-class stat counts: kernel K1 and its plain version.

Counterpart of ``torchmetrics_tpu/ops/stat_counts.py``. For ``(N, C)`` logits and
``(N,)`` targets it returns, over the valid rows (target in ``[0, C)`` and not
``ignore_index``)::

    tp[c]         = #{n : argmax(logits[n]) == c == target[n]}
    pred_count[c] = #{n : argmax(logits[n]) == c}
    tgt_count[c]  = #{n : target[n] == c}

where argmax takes the first index attaining the max and treats NaN as maximal.
``fp``, ``fn`` and ``tn`` follow arithmetically.

On a CUDA tensor the wrapper launches ``csrc/stat_counts.cu`` (which replaces the TPU
kernel ``_kernel`` / ``_fused_counts_pallas``; its header gives the bound on the card
and the design); on a CPU tensor it runs ``_stat_counts_plain``. There is no fallback
from one to the other. Counts are exact int32 for ``N < 2**31``: the TPU version's
f32 ``2**24`` row limit and its 4096-class VMEM cap do not apply.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.utilities.data import _bincount

#: kernel launches since import (or since a caller set it to 0)
LAUNCHES = 0

_FLOAT_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.float64: 3}
_THREADS = 256
_WARPS_PER_BLOCK = _THREADS // 32
_BLOCKS_PER_SM = 2048 // _THREADS


def _valid_rows(target: torch.Tensor, num_classes: int, ignore_index: Optional[int]) -> torch.Tensor:
    valid = (target >= 0) & (target < num_classes)
    if ignore_index is not None:
        valid &= target != ignore_index
    return valid


def _argmax_nan_first(preds: torch.Tensor) -> torch.Tensor:
    """Row argmax: first index attaining the max; any NaN is maximal (the first NaN wins)."""
    am = preds.argmax(dim=1)
    nan = torch.isnan(preds)
    first_nan = nan.to(torch.uint8).argmax(dim=1)
    return torch.where(nan.any(dim=1), first_nan, am)


def _stat_counts_plain(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (the counterpart of ``_counts_onehot_matmul``)."""
    valid = _valid_rows(target, num_classes, ignore_index)
    am = _argmax_nan_first(preds) if preds.shape[0] else target.new_zeros(0)
    # invalid rows go to an extra bin that is cut off
    drop = num_classes
    am_v = torch.where(valid, am, drop)
    tgt_v = torch.where(valid, target, drop).long()
    # fixed-size scatter counts (``_bincount``): a ``torch.bincount`` output is sized
    # from the data, which no captured graph can hold, while the kernel's is not
    tp = _bincount(torch.where(am_v == tgt_v, am_v, drop), minlength=num_classes)
    return tp, _bincount(am_v, minlength=num_classes), _bincount(tgt_v, minlength=num_classes)


def stat_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(tp, pred_count, tgt_count)``, each ``(C,)`` int32.

    Args:
        preds: ``(N, C)`` contiguous float32 / float16 / bfloat16 / float64 logits.
        target: ``(N,)`` int32 or int64 labels.
        num_classes: ``C``.
        ignore_index: target value whose rows count nowhere.
    """
    global LAUNCHES
    if preds.ndim != 2 or preds.shape[1] != num_classes:
        raise ValueError(f"expected logits of shape (N, {num_classes}), got {tuple(preds.shape)}")
    if target.shape != (preds.shape[0],):
        raise ValueError(f"expected target of shape ({preds.shape[0]},), got {tuple(target.shape)}")
    if preds.dtype not in _FLOAT_CODES:
        raise TypeError(f"logits must be float32, float16, bfloat16 or float64, got {preds.dtype}")
    if target.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"target must be int32 or int64, got {target.dtype}")
    if preds.device != target.device:
        raise ValueError(f"logits on {preds.device} but target on {target.device}")
    if not preds.is_cuda:
        return _stat_counts_plain(preds, target, num_classes, ignore_index)
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError("the stat-counts kernel needs contiguous logits and target")

    n = preds.shape[0]
    counts = torch.zeros((3, num_classes), dtype=torch.int32, device=preds.device)
    if n == 0:
        return counts[0], counts[1], counts[2]
    lib = _build.library()
    index = _build.device_index(preds.device)
    smem = 3 * num_classes * 4 <= _build.max_shared_optin(index)
    blocks_per_sm = _BLOCKS_PER_SM
    if smem:
        # one wave of resident blocks (an SM holds 228 KB of shared memory, 1 KB of it
        # reserved per block); each block loops over rows, so it zeroes and flushes its
        # histogram once
        blocks_per_sm = max(1, min(_BLOCKS_PER_SM, (228 * 1024) // (3 * num_classes * 4 + 1024)))
    grid = max(1, min(-(-n // _WARPS_PER_BLOCK), _build.sm_count(index) * blocks_per_sm))
    vec = preds.dtype == torch.float32 and num_classes % 4 == 0 and preds.data_ptr() % 16 == 0
    with torch.cuda.device(preds.device):
        err = lib.tm_stat_counts(
            preds.data_ptr(),
            _FLOAT_CODES[preds.dtype],
            target.data_ptr(),
            int(target.dtype == torch.int64),
            n,
            num_classes,
            int(ignore_index is not None),
            0 if ignore_index is None else int(ignore_index),
            int(vec),
            grid,
            int(smem),
            counts.data_ptr(),
            torch.cuda.current_stream(preds.device).cuda_stream,
        )
    _build.check(err, "stat_counts kernel launch")
    LAUNCHES += 1
    return counts[0], counts[1], counts[2]
