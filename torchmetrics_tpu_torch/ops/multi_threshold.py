"""Multi-threshold counting, the binned-curve hot op: kernel K2 and its plain version.

Counterpart of ``torchmetrics_tpu/ops/multi_threshold.py`` and of the arithmetic of the
JAX package's ``_binned_multi_threshold_confmat``. For every threshold ``t`` and class
``c``::

    tp[t, c]      = #{n : preds[n, c] >= thr[t] and positive[n, c] and valid[n, c]}
    predpos[t, c] = #{n : preds[n, c] >= thr[t] and valid[n, c]}

and, with the per-class totals ``P[c]`` (positive and valid) and ``V[c]`` (valid), the
``(T, C, 2, 2)`` int32 confusion tensor ``[[tn, fp], [fn, tp]]`` with
``fp = predpos - tp``, ``fn = P - tp`` and ``tn = V - P - fp``. NaN scores fall below
every threshold. Both versions bin each score (bin = #thresholds <= score), histogram
the bins per class and take suffix sums: O(N*C) work beside O(N*C*T) on the TPU.

The thresholds arrive sorted, with the permutation that sorted them
(``sort_thresholds``): a metric's thresholds are fixed at construction, so it sorts
once. ``multi_threshold_confmat`` is the entry point. On a CUDA tensor it launches
``csrc/multi_threshold.cu`` once (which replaces the TPU kernel ``_kernel`` /
``_counts_pallas``; its header gives the bound on the card and the design), beside one
memset of its scratch; the launch plan (class tile, grid, shared memory) is cached per
device and shape. On a CPU tensor it runs ``_multi_threshold_confmat_plain``. There is
no fallback from one to the other. ``multi_threshold_counts`` reads
``(tp, predpos, P, V)`` back out of the tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

#: kernel launches since import (or since a caller set it to 0)
LAUNCHES = 0

_FLAG_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64)
_THREADS = 256
_INT32_LIMIT = 2**31 - 1
# static shared memory of the kernel (its grid parameters, counters and flag), rounded up
_STATIC_SMEM = 64

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sort_thresholds(thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted float32 thresholds, int64 order)`` with ``sorted[k] == thresholds[order[k]]``."""
    values, order = torch.sort(thresholds.to(torch.float32))
    return values.contiguous(), order.contiguous()


def _multi_threshold_plain(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> Counts:
    """``(tp, predpos, pos_total, tot_total)`` in plain PyTorch (the counterpart of ``_counts_histogram``)."""
    n, c = preds.shape
    t = thr_sorted.shape[0]
    bins = torch.searchsorted(thr_sorted, preds.contiguous(), right=True)
    bins = torch.where(torch.isnan(preds), 0, bins)
    flat = (bins + (t + 1) * torch.arange(c, device=preds.device)[None, :]).reshape(-1)
    v = valid.bool()
    hists = []
    for weight in (positive.bool() & v, v):
        hist = torch.zeros(c * (t + 1), dtype=torch.int64, device=preds.device)
        hists.append(hist.scatter_add_(0, flat, weight.reshape(-1).long()).reshape(c, t + 1).cumsum(dim=1))
    out = []
    for cum in hists:
        # score >= sorted_thr[k] <=> bin > k: suffix sums past k, unsorted at the end
        counts_sorted = (cum[:, -1:] - cum[:, :t]).T
        unsorted = torch.empty_like(counts_sorted)
        unsorted[order] = counts_sorted
        out.append(unsorted.to(torch.int32))
    return out[0], out[1], hists[0][:, -1].to(torch.int32), hists[1][:, -1].to(torch.int32)


def _multi_threshold_confmat_plain(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K2: the ``(T, C, 2, 2)`` int32 confusion tensor."""
    tp, predpos, pos_total, tot_total = _multi_threshold_plain(preds, positive, valid, thr_sorted, order)
    fp = predpos - tp
    fn = pos_total[None, :] - tp
    tn = (tot_total - pos_total)[None, :] - fp
    return torch.stack([tn, fp, fn, tp], dim=-1).reshape(*tp.shape, 2, 2)


class _Plan(NamedTuple):
    """How one launch covers an (N, C, T) problem on one device."""

    smem: bool  # the tile's histograms live in shared memory
    tw_log: int  # classes per block: 2**tw_log
    rows_per_chunk: int
    row_chunks: int
    cells: int  # cells of the bin-lookup grid
    smem_bytes: int
    scratch_words: int  # zeroed int64 words: C*(T+1) histograms, then the tickets


@functools.lru_cache(maxsize=256)
def _plan(index: int, n: int, c: int, t: int) -> _Plan:
    """The launch plan, cached per ``(device, N, C, T)``: no device query or plan
    arithmetic on a repeated call."""
    return _make_plan(n, c, t, _build.sm_count(index), _build.max_shared_optin(index) - _STATIC_SMEM)


def _make_plan(n: int, c: int, t: int, sms: int, max_smem: int) -> _Plan:
    bins = t + 1
    cells = min(max(32, 1 << (2 * t - 1).bit_length()), 4096)  # a power of two >= 2T
    table = 4 * (cells + 1)
    target = 4 * sms  # blocks: about four resident per SM
    smem = 8 * bins + 4 * t + table <= max_smem
    best = None
    for tw_log in (4, 3, 2, 1, 0):
        tw = 1 << tw_log
        if tw > c and tw_log:
            continue
        if smem and 8 * tw * bins + 4 * t + table > max_smem:
            continue
        tiles = -(-c // tw)
        # enough rows that a block bins at least twice the histogram entries it zeroes
        # and flushes, and at least 2 elements per thread
        min_rows = max(2 * bins if smem else 1, -(-2 * _THREADS // tw))
        chunks = max(1, min(-(-n // min_rows), -(-target // tiles)))
        blocks = tiles * chunks
        if best is None or blocks > best[0]:
            best = (blocks, tw_log, chunks)
        if blocks >= target:
            break
    _, tw_log, chunks = best
    rows_per_chunk = -(-n // chunks)
    row_chunks = -(-n // rows_per_chunk)
    tiles = -(-c // (1 << tw_log))
    smem_bytes = table + (8 * (1 << tw_log) * bins + 4 * t if smem else 0)
    return _Plan(smem, tw_log, rows_per_chunk, row_chunks, cells, smem_bytes, c * bins + -(-tiles // 2))


def _max_offset(x: torch.Tensor) -> int:
    return sum((size - 1) * stride for size, stride in zip(x.shape, x.stride()) if size)


def _check_inputs(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> None:
    if preds.ndim != 2:
        raise ValueError(f"expected (N, C) scores, got shape {tuple(preds.shape)}")
    if positive.shape != preds.shape or valid.shape != preds.shape:
        raise ValueError(
            f"positive {tuple(positive.shape)} and valid {tuple(valid.shape)} must match preds {tuple(preds.shape)}"
        )
    if preds.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {preds.dtype}")
    for name, x in (("positive", positive), ("valid", valid)):
        if x.dtype not in _FLAG_DTYPES:
            raise TypeError(f"{name} must be bool, uint8, int8, int32 or int64, got {x.dtype}")
    if thr_sorted.ndim != 1 or order.shape != thr_sorted.shape:
        raise ValueError("thr_sorted and order must be 1-D and of the same length")
    if thr_sorted.dtype != torch.float32 or order.dtype != torch.int64:
        raise TypeError("thr_sorted must be float32 and order int64 (see sort_thresholds)")
    devices = {x.device for x in (preds, positive, valid, thr_sorted, order)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(str(d) for d in devices)}")


def multi_threshold_confmat(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """The ``(T, C, 2, 2)`` int32 confusion tensor ``[[tn, fp], [fn, tp]]`` per threshold.

    Args:
        preds: ``(N, C)`` float32 scores (contiguous on CUDA).
        positive: ``(N, C)`` 0/1 ground-truth membership, bool or integer, any strides.
        valid: ``(N, C)`` mask of elements to count, bool or integer, any strides (an
            ``expand``-ed ``(N, 1)`` mask is read without copying).
        thr_sorted, order: from ``sort_thresholds``.
    """
    global LAUNCHES
    _check_inputs(preds, positive, valid, thr_sorted, order)
    if not preds.is_cuda:
        return _multi_threshold_confmat_plain(preds, positive, valid, thr_sorted, order)
    if not (preds.is_contiguous() and thr_sorted.is_contiguous() and order.is_contiguous()):
        raise ValueError("the multi-threshold kernel needs contiguous scores, thresholds and order")
    n, c = preds.shape
    t = thr_sorted.shape[0]
    dev = preds.device
    if n == 0 or c == 0 or t == 0:
        return torch.zeros((t, c, 2, 2), dtype=torch.int32, device=dev)
    if max(_max_offset(preds), _max_offset(positive), _max_offset(valid), 4 * t * c, c * (t + 1)) > _INT32_LIMIT:
        raise ValueError(f"(N, C, T) = ({n}, {c}, {t}) is too large for the kernel's 32-bit indexing")
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    plan = _plan(index, n, c, t)
    out = torch.empty((t, c, 2, 2), dtype=torch.int32, device=dev)
    scratch = torch.zeros(plan.scratch_words, dtype=torch.int64, device=dev)
    args = (
        preds.data_ptr(), n, c,
        positive.data_ptr(), positive.stride(0), positive.stride(1), positive.element_size(),
        valid.data_ptr(), valid.stride(0), valid.stride(1), valid.element_size(),
        thr_sorted.data_ptr(), order.data_ptr(), t,
        plan.cells, plan.tw_log, plan.rows_per_chunk, plan.row_chunks, int(plan.smem), plan.smem_bytes,
        scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    lib = _build.library()
    if index == current:
        err = lib.tm_multi_threshold_confmat(*args)
    else:
        with torch.cuda.device(index):
            err = lib.tm_multi_threshold_confmat(*args)
    _build.check(err, "multi_threshold kernel launch")
    LAUNCHES += 1
    return out


def multi_threshold_counts(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> Counts:
    """``(tp, predpos, pos_total, tot_total)``: ``(T, C)``, ``(T, C)``, ``(C,)``, ``(C,)`` int32,
    read out of ``multi_threshold_confmat`` (same arguments; at least one threshold)."""
    if thr_sorted.ndim == 1 and thr_sorted.shape[0] == 0:
        raise ValueError("the per-class totals are read from the confusion tensor: give at least one threshold")
    cm = multi_threshold_confmat(preds, positive, valid, thr_sorted, order)
    tp = cm[..., 1, 1]
    pos_total = cm[0, :, 1, 0] + cm[0, :, 1, 1]
    return tp, cm[..., 0, 1] + tp, pos_total, pos_total + cm[0, :, 0, 0] + cm[0, :, 0, 1]
