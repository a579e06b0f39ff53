"""Next-token evaluation at DeepSeek-V3's vocabulary: the port's metrics, the seeded
logits and the bytes.

``MulticlassAccuracy(129280, ignore_index=-100)`` on the ``(B*S, V)`` view and
``Perplexity(ignore_index=-100)`` on ``(B, S, V)``, both fed the same float32 logits.
A few seeded batches of ``B`` sequences of ``S`` tokens are made on the card and cycled;
each sequence ends in a run of padded positions whose target is ``-100``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from cudabench.harness.window import Batch

COUNT_BYTES = 4  # an int32 count
INDEX_BYTES = 8  # an int64 target


def _shape(cfg: dict, batch_rows: List[int]) -> Tuple[int, int, int]:
    s, v = cfg["seq_len"], cfg["vocab_size"]
    if len(set(batch_rows)) != 1:
        raise ValueError(f"the cycled batches take one size, not {sorted(set(batch_rows))}")
    if batch_rows[0] % s:
        raise ValueError(f"a batch of {batch_rows[0]} tokens is no whole number of {s}-token sequences")
    return batch_rows[0] // s, s, v


def make_data(cfg: dict, seed: int, device, batch_rows: List[int]) -> Dict[str, Any]:
    """``batches_cycled`` batches of logits and targets, drawn on ``device`` from ``seed``,
    the logits in the configuration's ``dtype``."""
    b, s, v = _shape(cfg, batch_rows)
    p = cfg["logits"]
    dtype = getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    token_of_rank = torch.randperm(v, generator=g, device=device)
    weights = torch.arange(1, v + 1, device=device, dtype=torch.float64) ** -p["zipf_exponent"]
    cdf = torch.cumsum(weights, 0) / weights.sum()
    positions = torch.arange(s, device=device)
    rows = torch.arange(b * s, device=device)
    # every batch pads the same lengths, evenly spaced up to the longest, in a seeded
    # order: the seed changes which sequence is short, never how many tokens are scored
    pads = torch.linspace(0, int(cfg["pad_share_max"] * s), b, device=device).round().long()
    logits, targets, scored = [], [], []
    for _ in range(cfg["batches_cycled"]):
        u = torch.rand(b * s, generator=g, device=device, dtype=torch.float64)
        drawn = token_of_rank[torch.searchsorted(cdf, u).clamp_(max=v - 1)]
        pad = pads[torch.randperm(b, generator=g, device=device)]
        target = torch.where(positions[None, :] >= s - pad[:, None], cfg["ignore_index"], drawn.view(b, s))
        x = torch.randn(b, s, v, generator=g, device=device) * p["noise_std"]
        boost = p["target_boost_mean"] + p["target_boost_std"] * torch.randn(b * s, generator=g, device=device)
        x.view(-1, v)[rows, drawn] += boost
        logits.append(x.to(dtype))
        targets.append(target)
        scored.append(int((target != cfg["ignore_index"]).sum()))
    return {"logits": logits, "target": targets, "scored": scored}


def build(cfg: dict, device) -> Dict[str, Any]:
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.text import Perplexity

    return {
        "accuracy": MulticlassAccuracy(cfg["vocab_size"], ignore_index=cfg["ignore_index"],
                                       validate_args=cfg["validate_args"], device=device),
        "perplexity": Perplexity(ignore_index=cfg["ignore_index"], device=device),
    }


def plan(cfg: dict, batch_rows: List[int], rank: int = 0, world: int = 1) -> List[int]:
    """The cycle: each made batch once, in order."""
    if world != 1:
        raise ValueError("this configuration runs on one card")
    return list(range(cfg["batches_cycled"]))


def batch(data: Dict[str, Any], k: int) -> Batch:
    logits, target = data["logits"][k], data["target"][k]
    return Batch((logits, target), data["scored"][k], k,
                 logits.numel() * logits.element_size() + target.numel() * INDEX_BYTES)


def update(metrics: Dict[str, Any], b: Batch) -> None:
    logits, target = b.args
    metrics["accuracy"].update(logits.view(-1, logits.shape[-1]), target.view(-1))
    metrics["perplexity"].update(logits, target)


def compute(metrics: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {name: m.compute() for name, m in metrics.items()}


def reset(metrics: Dict[str, Any]) -> None:
    for m in metrics.values():
        m.reset()


def read_epoch(out: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in out.items()}


def read_final(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """The states the window left, and the values ``compute`` makes of them, on the host."""
    acc, ppl = metrics["accuracy"], metrics["perplexity"]
    out = {name: getattr(acc, name).cpu().numpy() for name in ("tp", "fp", "tn", "fn")}
    out["total_log_probs"] = float(ppl.total_log_probs)
    out["count"] = int(ppl.count)
    out.update(read_epoch(compute(metrics)))
    return out


def k1_bytes(b: Batch) -> int:
    """One stat-counts pass over the batch: logits and targets read once, 3 int32 counts
    per class written once."""
    return b.nbytes + 3 * b.args[0].shape[-1] * COUNT_BYTES


def state_bytes(cfg: dict, b: Batch) -> int:
    """The accuracy's 4 counts per class and perplexity's sum and count."""
    return (4 * cfg["vocab_size"] + 2) * COUNT_BYTES


def input_bytes(b: Batch) -> int:
    return b.nbytes
