"""Multi-threshold counting, the binned-curve hot op: kernel K2 and its plain version.

Counterpart of ``torchmetrics_tpu/ops/multi_threshold.py``. For every threshold ``t``
and class ``c``::

    tp[t, c]      = #{n : preds[n, c] >= thr[t] and positive[n, c] and valid[n, c]}
    predpos[t, c] = #{n : preds[n, c] >= thr[t] and valid[n, c]}

NaN scores fall below every threshold. Both versions bucketise each score by binary
search over the sorted thresholds, histogram the buckets per class and take suffix
sums: O(N*C*log T). They also return the per-class totals ``pos_total[c]`` (positive
and valid) and ``tot_total[c]`` (valid), which are the histograms' sums.

The thresholds arrive sorted, with the permutation that sorted them
(``sort_thresholds``): a metric's thresholds are fixed at construction, so it sorts
once. On a CUDA tensor the wrapper launches ``csrc/multi_threshold.cu`` (which
replaces the TPU kernel ``_kernel`` / ``_counts_pallas``; its header gives the bound on
the card and the design); on a CPU tensor it runs ``_multi_threshold_plain``. There
is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import _build

#: kernel launches since import (or since a caller set it to 0)
LAUNCHES = 0

_FLAG_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int32, torch.int64)
_THREADS = 256
_DEFAULT_SMEM = 48 * 1024
_MIN_BLOCK_ELEMENTS = 8 * _THREADS

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def sort_thresholds(thresholds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sorted float32 thresholds, int64 order)`` with ``sorted[k] == thresholds[order[k]]``."""
    values, order = torch.sort(thresholds.to(torch.float32))
    return values.contiguous(), order.contiguous()


def _multi_threshold_plain(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> Counts:
    """Plain PyTorch version of K2 (the counterpart of ``_counts_histogram``)."""
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


def _class_tile(c: int, t: int, budget: int) -> int:
    """Classes per block whose thresholds + two histograms fit ``budget`` bytes."""
    return min(c, (budget - 4 * t) // (8 * (t + 1)))


def multi_threshold_counts(
    preds: torch.Tensor, positive: torch.Tensor, valid: torch.Tensor, thr_sorted: torch.Tensor, order: torch.Tensor
) -> Counts:
    """``(tp, predpos, pos_total, tot_total)``: ``(T, C)``, ``(T, C)``, ``(C,)``, ``(C,)`` int32.

    Args:
        preds: ``(N, C)`` float32 scores (contiguous on CUDA).
        positive: ``(N, C)`` 0/1 ground-truth membership, bool or integer, any strides.
        valid: ``(N, C)`` mask of elements to count, bool or integer, any strides (an
            ``expand``-ed ``(N, 1)`` mask is read without copying).
        thr_sorted, order: from ``sort_thresholds``.
    """
    global LAUNCHES
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
    if not preds.is_cuda:
        return _multi_threshold_plain(preds, positive, valid, thr_sorted, order)
    if not (preds.is_contiguous() and thr_sorted.is_contiguous() and order.is_contiguous()):
        raise ValueError("the multi-threshold kernel needs contiguous scores, thresholds and order")

    n, c = preds.shape
    t = thr_sorted.shape[0]
    dev = preds.device
    if n == 0 or c == 0:
        zeros = torch.zeros((t, c), dtype=torch.int32, device=dev)
        return zeros, zeros.clone(), zeros.new_zeros(c), zeros.new_zeros(c)
    # the scan kernel writes every entry of these
    tp = torch.empty((t, c), dtype=torch.int32, device=dev)
    predpos = torch.empty((t, c), dtype=torch.int32, device=dev)
    totals = torch.empty((2, c), dtype=torch.int32, device=dev)
    lib = _build.library()
    index = _build.device_index(dev)
    smem = True
    class_tile = _class_tile(c, t, _DEFAULT_SMEM)
    if class_tile < 1:
        class_tile = _class_tile(c, t, _build.max_shared_optin(index))
    if class_tile < 1:
        # even one class's histograms exceed shared memory: bin against global memory
        smem, class_tile = False, min(c, 32)
    hist_entries = 2 * class_tile * (t + 1) if smem else 0
    # enough elements per block that zeroing and flushing its histograms stays minor
    rows_per_chunk = -(-max(_MIN_BLOCK_ELEMENTS, hist_entries) // class_tile)
    row_chunks = -(-n // rows_per_chunk)
    hists = torch.zeros((2, c, t + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.tm_multi_threshold_counts(
            preds.data_ptr(), n, c,
            positive.data_ptr(), positive.stride(0), positive.stride(1), positive.element_size(),
            valid.data_ptr(), valid.stride(0), valid.stride(1), valid.element_size(),
            thr_sorted.data_ptr(), order.data_ptr(), t,
            class_tile, rows_per_chunk, row_chunks, int(smem),
            hists[0].data_ptr(), hists[1].data_ptr(),
            tp.data_ptr(), predpos.data_ptr(), totals[0].data_ptr(), totals[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "multi_threshold kernel launch")
    LAUNCHES += 1
    return tp, predpos, totals[0], totals[1]
