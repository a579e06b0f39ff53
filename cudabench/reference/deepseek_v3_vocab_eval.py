"""Plain reference for the vocabulary eval, and the numbers that compare the program's
states and values with it.

Plain PyTorch over the same logits and targets the program gets; nothing of the
program is imported or read. Per batch, over the tokens whose target is not the
ignore index, in blocks of rows, computed in float64 (``rounding=torch.float32``, the
configuration's precision: float32 logits widen exactly) or in the dtype given, every
result of the batch in that dtype (the control's bfloat16):

- per class: true positives (prediction, the first index of the row's maximum, equals
  the target), false positives (predicted, not the target), false negatives (the
  target, not predicted), true negatives (the scored tokens less those three);
- the sum of ``logsumexp(row) - row[target]`` and the count of scored tokens.

The window's final states are each batch's counts times the number of times the window
folded it; macro accuracy averages ``tp / (tp + fn)`` over the classes with any of tp,
fp, fn, and perplexity is ``exp(sum / count)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BLOCK_ROWS = 512


def _work_dtype(rounding: torch.dtype) -> torch.dtype:
    return torch.float64 if rounding == torch.float32 else rounding


def batch_counts(logits: torch.Tensor, target: torch.Tensor, ignore_index: int, rounding=torch.float32) -> dict:
    work = _work_dtype(rounding)
    v = logits.shape[-1]
    x_all, t_all = logits.reshape(-1, v), target.reshape(-1)
    tp = torch.zeros(v, dtype=torch.int64, device=logits.device)
    fp, fn = torch.zeros_like(tp), torch.zeros_like(tp)
    nll = torch.zeros((), dtype=work, device=logits.device)
    scored = 0
    for s in range(0, x_all.shape[0], BLOCK_ROWS):
        t = t_all[s:s + BLOCK_ROWS]
        keep = t != ignore_index
        x = x_all[s:s + BLOCK_ROWS][keep].to(work)
        t = t[keep]
        top = x.max(dim=1, keepdim=True).values
        pred = (x == top).to(torch.int8).argmax(dim=1)
        hit = pred == t
        tp += torch.bincount(t[hit], minlength=v)
        fp += torch.bincount(pred[~hit], minlength=v)
        fn += torch.bincount(t[~hit], minlength=v)
        lse = torch.logsumexp(x, dim=1)
        nll += (lse - x.gather(1, t[:, None]).squeeze(1)).sum()
        scored += int(keep.sum())
    return {"tp": tp.cpu().numpy(), "fp": fp.cpu().numpy(), "fn": fn.cpu().numpy(), "nll": float(nll), "count": scored}


def expected(cfg: dict, data: dict, plan: list, folds: Dict[int, int], rounding=torch.float32) -> dict:
    """The final states and values after the window folded batch ``k`` ``folds[k]`` times."""
    v = cfg["vocab_size"]
    tp, fp, fn = (np.zeros(v, dtype=np.int64) for _ in range(3))
    nll, count = 0.0, 0
    for k, times in sorted(folds.items()):
        c = batch_counts(data["logits"][k], data["target"][k], cfg["ignore_index"], rounding)
        tp += times * c["tp"]
        fp += times * c["fp"]
        fn += times * c["fn"]
        nll += times * c["nll"]
        count += times * c["count"]
    tn = count - tp - fp - fn
    present = (tp + fp + fn) > 0
    recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
    accuracy = float(recall[present].mean()) if present.any() else 0.0
    return {"final": {"tp": tp, "fp": fp, "tn": tn, "fn": fn, "nll": nll, "count": count,
                      "accuracy": accuracy, "perplexity": float(np.exp(nll / count))}}


def as_answer(want: dict) -> dict:
    """Reference values in the form the program's read gives them (for the control)."""
    out = {k: want[k] for k in ("tp", "fp", "tn", "fn", "count", "accuracy", "perplexity")}
    out["total_log_probs"] = want["nll"]
    return out


def _rel(got: float, want: float) -> float:
    return abs(float(got) - want) / abs(want) if want else abs(float(got))


def compare(got: dict, want: dict) -> Dict[str, float]:
    """Counts off (every per-class count and the count of scored tokens, summed) and
    relative gaps (the sum of negative log-likelihoods, macro accuracy, perplexity)."""
    off = sum(float(np.abs(np.asarray(got[k], dtype=np.int64) - want[k]).sum()) for k in ("tp", "fp", "tn", "fn"))
    return {
        "counts_off": off + float(abs(int(got["count"]) - want["count"])),
        "nll_sum_rel": _rel(got["total_log_probs"], want["nll"]),
        "acc_rel": _rel(got["accuracy"], want["accuracy"]),
        "ppl_rel": _rel(got["perplexity"], want["perplexity"]),
    }
