"""Each reference against counts made by hand at tiny sizes."""

import math

import numpy as np
import torch

from cudabench.harness import spec

IMAGENET = spec.load_module(spec.BENCH_DIR / "reference" / "imagenet1k_suite.py")
VOCAB = spec.load_module(spec.BENCH_DIR / "reference" / "deepseek_v3_vocab_eval.py")

# five rows of six classes: a hit, a miss at rank 1, a hit, a tie (the lower index wins),
# and a target ranked sixth
LOGITS = torch.tensor([
    [3.0, 1, 0, 0, 0, 0],
    [1.0, 2, 0, 0, 0, 0],
    [0.0, 0, 5, 0, 0, 0],
    [1.0, 1, 0, 0, 0, 0],
    [0.0, 1, 2, 3, 4, 5],
])
TARGET = torch.tensor([0, 0, 2, 1, 0])


def _ece_by_loop(logits, target, n_bins):
    p = torch.softmax(logits.double(), 1).numpy()
    conf, pred = p.max(1), p.argmax(1)
    edges = [np.float64(np.float32(i) * np.float32(1.0 / n_bins)) for i in range(n_bins)] + [1.0]
    total = 0.0
    for b in range(n_bins + 1):
        lo = edges[b]
        hi = edges[b + 1] if b < n_bins else math.inf
        rows = [i for i in range(len(conf)) if lo <= conf[i] < hi or (b == n_bins and conf[i] >= 1.0)]
        if rows:
            acc = np.mean([pred[i] == target[i] for i in rows])
            total += abs(acc - np.mean(conf[rows])) * len(rows) / len(conf)
    return total


def test_imagenet_rows_by_hand():
    rows = IMAGENET.per_row(LOGITS, TARGET)
    assert rows["pred"].tolist() == [0, 1, 2, 0, 5]
    assert rows["rank"].tolist() == [0, 1, 0, 1, 5]


def test_imagenet_values_by_hand():
    v = IMAGENET.values(IMAGENET.per_row(LOGITS, TARGET), num_classes=6, n_bins=15)
    assert v["rows"] == 5 and v["top1_count"] == 2 and v["top5_count"] == 4
    cm = np.zeros((6, 6), dtype=np.int64)
    for t, p in [(0, 0), (0, 1), (2, 2), (1, 0), (0, 5)]:
        cm[t, p] += 1
    assert (v["confmat"] == cm).all()
    # F1 per class: 0.4, 0, 1, 0 over the four classes seen as target or prediction
    assert v["f1"] == (0.4 + 0 + 1 + 0) / 4
    assert abs(v["ece"] - _ece_by_loop(LOGITS, TARGET.numpy(), 15)) < 1e-12


def test_imagenet_expected_splits_epoch_and_steps():
    cfg = {"num_classes": 6, "n_bins": 15}
    want = IMAGENET.expected(cfg, {"logits": LOGITS, "target": TARGET}, [(0, 0, 3), (1, 3, 2)], {})
    assert want["epoch"]["top1_count"] == 2
    assert want["step"][0]["top1_count"] == 2 and want["step"][1]["top1_count"] == 0
    assert want["step"][1]["rows"] == 2


def test_imagenet_compare_counts_rows():
    cfg = {"num_classes": 6, "n_bins": 15}
    want = IMAGENET.expected(cfg, {"logits": LOGITS, "target": TARGET}, [(0, 0, 5)], {})["epoch"]
    got = IMAGENET.as_answer(want)
    assert all(v == 0 for v in IMAGENET.compare(got, want).values())
    got = dict(got, top1=3 / 5, confmat=want["confmat"] + np.eye(6, dtype=np.int64))
    gaps = IMAGENET.compare(got, want)
    assert abs(gaps["topk_off"] - 1.0) < 1e-9 and gaps["confmat_off"] == 6


def test_vocab_counts_by_hand():
    logits = torch.tensor([[[2.0, 0, 0, 0], [0, 3, 1, 0], [9, 9, 9, 9]]])
    target = torch.tensor([[0, 2, -100]])
    c = VOCAB.batch_counts(logits, target, -100)
    assert c["tp"].tolist() == [1, 0, 0, 0] and c["fp"].tolist() == [0, 1, 0, 0] and c["fn"].tolist() == [0, 0, 1, 0]
    assert c["count"] == 2
    nll = (math.log(math.exp(2) + 3) - 2) + (math.log(2 + math.exp(3) + math.exp(1)) - 1)
    assert abs(c["nll"] - nll) < 1e-12

    want = VOCAB.expected({"vocab_size": 4, "ignore_index": -100}, {"logits": [logits], "target": [target]}, [0], {0: 2})
    f = want["final"]
    assert f["tp"].tolist() == [2, 0, 0, 0] and f["tn"].tolist() == [2, 2, 2, 4] and f["count"] == 4
    assert abs(f["accuracy"] - 1 / 3) < 1e-12
    assert abs(f["perplexity"] - math.exp(nll / 2)) < 1e-9
    assert all(v == 0 for v in VOCAB.compare(VOCAB.as_answer(f), f).values())
