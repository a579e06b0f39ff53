"""The bytes behind each roofline, at the cells' own shapes (meta tensors: nothing is
allocated)."""

import torch

from cudabench.harness import peaks, spec

IMAGENET = spec.load_module(spec.BENCH_DIR / "configs" / "imagenet1k_suite.py")
VOCAB = spec.load_module(spec.BENCH_DIR / "configs" / "deepseek_v3_vocab_eval.py")
META = torch.device("meta")


def test_imagenet_bytes():
    cfg = spec.resolve("imagenet1k_suite.b4096").config
    data = {"logits": torch.empty(50000, 1000, device=META), "target": torch.empty(50000, dtype=torch.int64, device=META)}
    full = IMAGENET.batch(data, (0, 0, 4096))
    tail = IMAGENET.batch(data, (12, 49152, 848))
    assert IMAGENET.input_bytes(full) == 4096 * 1000 * 4 + 4096 * 8 == 16_416_768
    assert IMAGENET.k1_bytes(full) == 16_416_768 + 3 * 1000 * 4
    assert IMAGENET.input_bytes(tail) == 848 * 1000 * 4 + 848 * 8
    assert IMAGENET.state_bytes(cfg, full) == (4 * 1000 + 8 + 1000 * 1000) * 4 + 2 * 4096 * 4 == 4_048_800


def test_vocab_bytes():
    cfg = spec.resolve("deepseek_v3_vocab_eval.b8192").config
    data = {"logits": [torch.empty(4, 2048, 129280, device=META)],
            "target": [torch.empty(4, 2048, dtype=torch.int64, device=META)], "scored": [7800]}
    b = VOCAB.batch(data, 0)
    assert b.rows == 7800
    assert VOCAB.input_bytes(b) == 8192 * 129280 * 4 + 8192 * 8 == 4_236_312_576
    assert VOCAB.k1_bytes(b) == 4_236_312_576 + 3 * 129280 * 4
    assert VOCAB.state_bytes(cfg, b) == (4 * 129280 + 2) * 4
    # the bound of one K1 pass on an H100 SXM: about 1.27 ms
    assert abs(VOCAB.k1_bytes(b) / peaks.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") - 1.2650e-3) < 1e-6


def test_peaks_by_card_name():
    assert peaks.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.hbm_bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    assert peaks.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
