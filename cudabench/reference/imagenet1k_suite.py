"""Plain reference for the ImageNet-1k suite, and the numbers that compare the
program's answers with it.

Plain PyTorch over the same logits and targets the program gets; nothing of the
program is imported or read. Each row's prediction, the rank of its target and its
top-1 confidence are worked out in float64 (``rounding=torch.float32``, the
configuration's precision: float32 logits widen exactly) or in the dtype given (the
control's bfloat16), and the epoch's and each batch's values follow from those rows:

- top-1: the first index of the row's maximum; top-5: the target ranks below 5, where
  rank counts the larger logits and the equal ones at lower indices;
- the confusion matrix, ``[target, prediction]``;
- macro F1 over the classes that occur as a target or a prediction;
- the l1 calibration error over 15 bins whose edges are ``float32(i) * float32(1/15)``
  (the last set to 1), a confidence going to the last edge not above it, so a
  confidence of exactly 1 has a bin of its own.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

BLOCK_ROWS = 4096


def per_row(logits: torch.Tensor, target: torch.Tensor, rounding=torch.float32) -> Dict[str, torch.Tensor]:
    """Prediction, target rank and top-1 confidence of every row, in blocks of rows."""
    preds, ranks, confs = [], [], []
    cols = torch.arange(logits.shape[1], device=logits.device)
    for s in range(0, logits.shape[0], BLOCK_ROWS):
        x = logits[s:s + BLOCK_ROWS].to(torch.float64 if rounding == torch.float32 else rounding)
        t = target[s:s + BLOCK_ROWS]
        top = x.max(dim=1, keepdim=True).values
        preds.append((x == top).to(torch.int8).argmax(dim=1))
        xt = x.gather(1, t[:, None])
        ranks.append((x > xt).sum(dim=1) + ((x == xt) & (cols[None, :] < t[:, None])).sum(dim=1))
        confs.append((1.0 / torch.exp(x - top).sum(dim=1)).to(torch.float64))
    return {"pred": torch.cat(preds), "rank": torch.cat(ranks), "conf": torch.cat(confs), "target": target}


def bin_edges(n_bins: int) -> torch.Tensor:
    edges = torch.arange(n_bins + 1, dtype=torch.float32) * torch.tensor(1.0 / n_bins, dtype=torch.float32)
    edges[-1] = 1.0
    return edges.to(torch.float64)


def values(rows: Dict[str, torch.Tensor], num_classes: int, n_bins: int) -> Dict[str, object]:
    """The suite's values over the given rows (float64, counts as int64)."""
    pred, target, conf = rows["pred"], rows["target"], rows["conf"]
    n = target.shape[0]
    cm = torch.bincount(target * num_classes + pred, minlength=num_classes * num_classes)
    cm = cm.reshape(num_classes, num_classes).cpu().numpy().astype(np.int64)
    tp = np.diag(cm)
    fp, fn = cm.sum(axis=0) - tp, cm.sum(axis=1) - tp
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    present = denom > 0
    f1_macro = float(f1[present].mean()) if present.any() else 0.0

    correct = (pred == target).to(torch.float64)
    edges = bin_edges(n_bins).to(conf.device)
    bins = torch.searchsorted(edges, conf, right=True) - 1
    count = torch.zeros(n_bins + 1, dtype=torch.float64, device=conf.device).index_add_(0, bins, torch.ones_like(conf))
    conf_sum = torch.zeros_like(count).index_add_(0, bins, conf)
    acc_sum = torch.zeros_like(count).index_add_(0, bins, correct)
    seen = count > 0
    ece = float(((acc_sum[seen] - conf_sum[seen]).abs()).sum() / n)
    return {
        "rows": n,
        "top1_count": int((pred == target).sum()),
        "top5_count": int((rows["rank"] < 5).sum()),
        "f1": f1_macro,
        "confmat": cm,
        "ece": ece,
    }


def _slice(rows: Dict[str, torch.Tensor], start: int, n: int) -> Dict[str, torch.Tensor]:
    return {k: v[start:start + n] for k, v in rows.items()}


def expected(cfg: dict, data: Dict[str, torch.Tensor], plan: List[tuple], folds: Dict[int, int],
             rounding=torch.float32) -> dict:
    """The values of the whole eval set (``epoch``: the synced values, whichever rank's
    shard ``plan`` holds) and of each of the rank's batches (``step``); the suite runs in
    epochs, so no state outlives the window and ``folds`` is unused."""
    rows = per_row(data["logits"], data["target"], rounding)
    c, nb = cfg["num_classes"], cfg["n_bins"]
    return {
        "epoch": values(rows, c, nb),
        "step": {index: values(_slice(rows, start, n), c, nb) for index, start, n in plan},
    }


def as_answer(want: dict) -> dict:
    """Reference values in the form the program's read gives them (for the control)."""
    n = want["rows"]
    return {"top1": want["top1_count"] / n, "top5": want["top5_count"] / n, "f1": want["f1"],
            "confmat": want["confmat"], "ece": want["ece"]}


def _rel(got: float, want: float) -> float:
    return abs(float(got) - want) / abs(want) if want else abs(float(got))


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The gaps between one answer and the reference's: counts off (top-1 and top-5
    accuracy each as value x rows against the count, summed, so 0.25 is a quarter of one
    row; every cell of the confusion matrix, summed) and relative gaps (F1, calibration
    error)."""
    n = want["rows"]
    gaps = {
        "topk_off": abs(float(got["top1"]) * n - want["top1_count"]) + abs(float(got["top5"]) * n - want["top5_count"]),
        "f1_rel": _rel(got["f1"], want["f1"]),
        "ece_rel": _rel(got["ece"], want["ece"]),
    }
    if "confmat" in got:
        gaps["confmat_off"] = float(np.abs(np.asarray(got["confmat"], dtype=np.int64) - want["confmat"]).sum())
    return gaps
