"""The seeded inputs: the same seed repeats them, another does not, and their row counts;
the configuration's dtype reaches the logits; a traffic's list of batch sizes and its
overrides of the configuration."""

import time

import torch

from cudabench.harness import spec, window
from cudabench.harness.cell import run_cell

IMAGENET = spec.load_module(spec.BENCH_DIR / "configs" / "imagenet1k_suite.py")
VOCAB = spec.load_module(spec.BENCH_DIR / "configs" / "deepseek_v3_vocab_eval.py")
CPU = torch.device("cpu")


def _imagenet_cfg(**sizes):
    return dict(spec.resolve("imagenet1k_suite.b4096").config, **sizes)


def _vocab_cfg(**sizes):
    return dict(spec.resolve("deepseek_v3_vocab_eval.b8192").config, **sizes)


def test_imagenet_repeats_and_counts():
    cfg = _imagenet_cfg(rows=300, num_classes=30, per_class=10)
    a, b = IMAGENET.make_data(cfg, 2**31 + 5, CPU, [128]), IMAGENET.make_data(cfg, 2**31 + 5, CPU, [128])
    c = IMAGENET.make_data(cfg, 2**31 + 6, CPU, [128])
    assert torch.equal(a["logits"], b["logits"]) and torch.equal(a["target"], b["target"])
    assert not torch.equal(a["logits"], c["logits"])
    assert a["logits"].shape == (300, 30) and a["logits"].dtype == torch.float32
    assert torch.bincount(a["target"], minlength=30).tolist() == [10] * 30


def test_imagenet_accuracy_near_resnet50():
    cfg = _imagenet_cfg(rows=20000, per_class=20)
    d = IMAGENET.make_data(cfg, 11, CPU, [4096])
    x, t = d["logits"], d["target"]
    rank = (x > x.gather(1, t[:, None])).sum(1)
    assert 0.72 < (rank == 0).double().mean() < 0.80
    assert 0.90 < (rank < 5).double().mean() < 0.97


def test_imagenet_plan_covers_the_epoch():
    cfg = _imagenet_cfg()
    plan = IMAGENET.plan(cfg, [4096])
    assert [n for _, _, n in plan] == [4096] * 12 + [848]
    assert sum(n for _, _, n in plan) == 50000
    shards = [IMAGENET.plan(cfg, [4096], r, 4) for r in range(4)]
    assert [sum(n for _, _, n in p) for p in shards] == [12500] * 4
    assert [n for _, _, n in shards[0]] == [4096, 4096, 4096, 212]


def test_vocab_repeats_and_counts():
    cfg = _vocab_cfg(vocab_size=64, seq_len=40, batches_cycled=3)
    a, b = VOCAB.make_data(cfg, 2**31 + 9, CPU, [80]), VOCAB.make_data(cfg, 2**31 + 9, CPU, [80])
    c = VOCAB.make_data(cfg, 3, CPU, [80])
    assert all(torch.equal(x, y) for x, y in zip(a["logits"], b["logits"]))
    assert not torch.equal(a["logits"][0], c["logits"][0])
    assert len(a["logits"]) == 3 and a["logits"][0].shape == (2, 40, 64)
    for t, scored in zip(a["target"], a["scored"]):
        assert scored == int((t != -100).sum())
        pads = sorted(int((row == -100).sum()) for row in t)
        assert pads == [0, 4]  # every batch, whatever the seed
        for row, pad in zip(t, (int((r == -100).sum()) for r in t)):
            assert (row[40 - pad:] == -100).all()
    assert a["scored"] == c["scored"] == [76, 76, 76]
    assert VOCAB.plan(cfg, [80]) == [0, 1, 2]


def test_vocab_batch_shape_must_be_whole_sequences():
    cfg = _vocab_cfg(vocab_size=64, seq_len=40)
    try:
        VOCAB.make_data(cfg, 1, CPU, [100])
    except ValueError:
        return
    raise AssertionError("a batch of 100 tokens is not whole 40-token sequences")


def test_vocab_one_size_only():
    cfg = _vocab_cfg(vocab_size=64, seq_len=40)
    try:
        VOCAB.make_data(cfg, 1, CPU, [80, 40])
    except ValueError:
        return
    raise AssertionError("the cycled batches take one size")


def test_imagenet_plan_takes_a_list_of_sizes_in_turn():
    cfg = _imagenet_cfg(rows=1000)
    plan = IMAGENET.plan(cfg, [300, 1, 64])
    assert [n for _, _, n in plan] == [300, 1, 64, 300, 1, 64, 270]
    assert [i for i, _, _ in plan] == list(range(7))
    assert [s for _, s, _ in plan] == [0, 300, 301, 365, 665, 666, 730]


def test_seeded_order_permutes_the_same_sizes():
    traffic = {"batch_rows": [1, 2, 3, 4, 5, 6, 7, 8], "order": "seeded"}
    a, b = window.batch_sizes(traffic, 2**31 + 1), window.batch_sizes(traffic, 2**31 + 1)
    c = window.batch_sizes(traffic, 2**31 + 2)
    assert a == b and a != c and sorted(a) == sorted(c) == list(range(1, 9))
    assert window.batch_sizes({"batch_rows": 4096}, 5) == [4096]
    assert window.batch_sizes({"batch_rows": [8, 4]}, 5) == [8, 4]


def test_bfloat16_configuration_feeds_bfloat16_logits():
    for module, cfg, rows in ((IMAGENET, _imagenet_cfg(rows=300, num_classes=30, per_class=10), [128]),
                              (VOCAB, _vocab_cfg(vocab_size=64, seq_len=40, batches_cycled=2), [80])):
        data = module.make_data(dict(cfg, dtype="bfloat16"), 2**31 + 3, CPU, rows)
        logits = data["logits"] if module is IMAGENET else data["logits"][0]
        assert logits.dtype == torch.bfloat16
        full = module.make_data(cfg, 2**31 + 3, CPU, rows)
        want = full["logits"] if module is IMAGENET else full["logits"][0]
        assert torch.equal(logits, want.to(torch.bfloat16))  # the same draw, cast


def test_traffic_overrides_reach_the_metrics(monkeypatch):
    """A traffic's ``config`` object overrides the configuration for its cells: a
    bfloat16 traffic's run hands the program bfloat16 logits, and the metrics are built
    with its ``validate_args``."""
    small = {"batch_rows": 128, "call": "update", "read_each_step": False, "epochs": True, "about": "-",
             "config": {"dtype": "bfloat16", "validate_args": True}}
    real = spec.load_traffic
    monkeypatch.setattr(spec, "load_traffic", lambda name: dict(small) if name == "bf16_small" else real(name))
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "imagenet1k_suite.bf16_small", "config": "imagenet1k_suite",
                               "traffic": "bf16_small", "chips": 1, "why": "-"})
    cell = spec.resolve("imagenet1k_suite.bf16_small", bench)
    assert cell.config["dtype"] == "bfloat16" and cell.config["validate_args"] is True
    assert spec.resolve("imagenet1k_suite.b4096").config["dtype"] == "float32"

    seen = []

    def record(metrics):
        inner = metrics.update

        def update(preds, target):
            seen.append(preds.dtype)
            return inner(preds, target)

        metrics.update = update
        assert all(m.validate_args for m in metrics.values())
        return metrics

    out = run_cell(cell, 2**31 + 21, 0.2, False, CPU, time.perf_counter(),
                   sizes={"rows": 600, "num_classes": 20, "per_class": 30}, wrap=record)
    assert seen and set(seen) == {torch.bfloat16}
    assert out.attempted > 0
