"""ImageNet-1k validation suite: the port's metrics, the seeded logits and the bytes.

One ``MetricCollection`` of top-1 and top-5 accuracy, macro F1, the 1000 x 1000
confusion matrix and the 15-bin calibration error over float32 logits of the whole
val set (50,000 x 1000, 200 MB), made on the card from the seed and kept there; each
epoch walks it in order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from cudabench.harness.window import Batch

COUNT_BYTES = 4  # an int32 count
INDEX_BYTES = 8  # an int64 target


def make_data(cfg: dict, seed: int, device, batch_rows: List[int]) -> Dict[str, torch.Tensor]:
    """The val set's logits and targets, drawn on ``device`` from ``seed`` (the whole set,
    whatever the batches), the logits in the configuration's ``dtype``."""
    n, c = cfg["rows"], cfg["num_classes"]
    p = cfg["logits"]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rows = torch.arange(n, device=device)
    target = torch.arange(c, device=device).repeat_interleave(cfg["per_class"])
    target = target[torch.randperm(n, generator=g, device=device)]
    logits = torch.randn(n, c, generator=g, device=device) * p["noise_std"]
    boost = p["target_boost_mean"] + p["target_boost_std"] * torch.randn(n, generator=g, device=device)
    logits[rows, target] += boost
    for _ in range(p["confusers"]):
        other = (target + torch.randint(1, c, (n,), generator=g, device=device)) % c
        logits[rows, other] += p["confuser_boost"]
    logits *= p["scale"]
    return {"logits": logits.to(getattr(torch, cfg["dtype"])), "target": target}


def build(cfg: dict, device):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassCalibrationError,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
    )

    c, kw = cfg["num_classes"], {"validate_args": cfg["validate_args"], "device": device}
    return MetricCollection({
        "top1": MulticlassAccuracy(c, average="micro", **kw),
        "top5": MulticlassAccuracy(c, top_k=5, average="micro", **kw),
        "f1": MulticlassF1Score(c, average="macro", **kw),
        "confmat": MulticlassConfusionMatrix(c, **kw),
        "ece": MulticlassCalibrationError(c, n_bins=cfg["n_bins"], **kw),
    })


def plan(cfg: dict, batch_rows: List[int], rank: int = 0, world: int = 1) -> List[Tuple[int, int, int]]:
    """One epoch as (index, first row, rows) slices of this rank's contiguous shard, the
    batches taking the sizes of ``batch_rows`` in turn, the last cut to what is left."""
    n = cfg["rows"]
    start, hi = n * rank // world, n * (rank + 1) // world
    out = []
    while start < hi:
        rows = min(batch_rows[len(out) % len(batch_rows)], hi - start)
        out.append((len(out), start, rows))
        start += rows
    return out


def batch(data: Dict[str, torch.Tensor], item: Tuple[int, int, int]) -> Batch:
    index, start, rows = item
    preds, target = data["logits"][start:start + rows], data["target"][start:start + rows]
    return Batch((preds, target), rows, index, preds.numel() * preds.element_size() + rows * INDEX_BYTES)


def update(metrics, b: Batch) -> None:
    metrics.update(*b.args)


def forward(metrics, b: Batch):
    return metrics(*b.args)


def compute(metrics):
    return metrics.compute()


def reset(metrics) -> None:
    metrics.reset()


def read_epoch(out: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Every value on the host, as a user's epoch end reads it."""
    return {k: v.cpu().numpy() for k, v in out.items()}


def read_step(out: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A progress bar's read: the scalar batch values in one copy."""
    names = [k for k, v in out.items() if v.ndim == 0]
    values = torch.stack([out[k].to(torch.float64) for k in names]).cpu().tolist()
    return dict(zip(names, values))


def k1_bytes(b: Batch) -> int:
    """One stat-counts pass: the logits and targets read once, 3 int32 counts per class
    written once."""
    preds, _ = b.args
    return b.nbytes + 3 * preds.shape[1] * COUNT_BYTES


def state_bytes(cfg: dict, b: Batch) -> int:
    """What one update must write at least: the stat-score counts of the three
    stat-scores members (4 per class for macro F1, 4 each for the micro accuracies),
    the confusion matrix, and the calibration error's confidence and correctness per
    row (float32 each)."""
    c = cfg["num_classes"]
    return (4 * c + 4 + 4 + c * c) * COUNT_BYTES + 2 * b.rows * 4


def input_bytes(b: Batch) -> int:
    return b.nbytes
