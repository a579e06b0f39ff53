"""CLIPScore: the port (on the CPU) against the JAX package.

Both packages load one tiny local ``save_pretrained`` CLIP checkpoint, built as
``tests/text/test_hf_backed.py`` builds its own (two-layer towers, a seven-word
tokenizer, a 32 x 32 processor). ``clip_score`` and the modular ``compute`` equal the
JAX values within ``ATOL`` on the 0-100 scale: the towers are the same torch modules,
run in float32 on both sides, and the cosine is taken in float32 by each. The
``embed_fn`` injection, the uncached checkpoint's error and the 3-d and count checks
behave as in the JAX package; a JAX ``CLIPScore`` state carries into the port through
``interop.state_from_jax``; the engine leaves the update to the eager path
(``chip_smoke.AUDIO_FALLBACK_REASONS["clip"]``), and the loaded towers are shared, never
copied or moved by a metric.
"""

from __future__ import annotations

import copy
import doctest
import importlib
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torchmetrics_tpu.functional.multimodal as jF
import torchmetrics_tpu.multimodal as jm
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional.multimodal as tF
import torchmetrics_tpu_torch.multimodal as tm
from tests.torch_parity import assert_close
from torchmetrics_tpu_torch.functional.multimodal.clip_score import _get_model_and_processor
from torchmetrics_tpu_torch.interop import state_from_jax

transformers = pytest.importorskip("transformers")

ATOL = 1e-5
CAPTIONS = ["a photo of a cat", "a photo of a dog", "a dog", "a cat of a photo", "photo", "a cat a dog"]


@pytest.fixture(scope="module")
def tiny_clip_dir(tmp_path_factory):
    """A local save_pretrained CLIP checkpoint: tiny towers, tokenizer and processor."""
    d = tmp_path_factory.mktemp("tiny_clip_port")
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1, "a</w>": 2, "photo</w>": 3, "of</w>": 4, "cat</w>": 5,
             "dog</w>": 6}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    transformers.CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt")).save_pretrained(str(d))
    config = transformers.CLIPConfig(
        text_config={"vocab_size": len(vocab), "hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
                     "intermediate_size": 32, "max_position_embeddings": 16, "projection_dim": 8},
        vision_config={"hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 32,
                       "image_size": 32, "patch_size": 8, "projection_dim": 8},
        projection_dim=8,
    )
    torch.manual_seed(0)
    transformers.CLIPModel(config).eval().save_pretrained(str(d))
    transformers.CLIPImageProcessor(size={"shortest_edge": 32}, crop_size={"height": 32, "width": 32}).save_pretrained(
        str(d)
    )
    yield str(d)
    _get_model_and_processor.cache_clear()


def _images(seed: int, n: int, size=(32, 32)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, 3, *size), dtype=np.uint8)


def test_clip_score_functional_matches_jax(tiny_clip_dir):
    imgs = _images(0, 4)
    port = tF.clip_score(torch.from_numpy(imgs), CAPTIONS[:4], tiny_clip_dir, device="cpu")
    ref = jF.clip_score(jnp.asarray(imgs), CAPTIONS[:4], tiny_clip_dir)
    assert port.dtype == torch.float32 and port.shape == ()
    assert_close(port, ref, ATOL)
    # one 3-d image with one caption, and a list of images of other sizes
    one = imgs[0]
    assert_close(tF.clip_score(torch.from_numpy(one), "a photo", tiny_clip_dir, device="cpu"),
                 jF.clip_score(jnp.asarray(one), "a photo", tiny_clip_dir), ATOL)
    mixed = [_images(1, 1, (40, 48))[0], _images(2, 1, (64, 32))[0]]
    assert_close(tF.clip_score([torch.from_numpy(x) for x in mixed], CAPTIONS[:2], tiny_clip_dir, device="cpu"),
                 jF.clip_score([jnp.asarray(x) for x in mixed], CAPTIONS[:2], tiny_clip_dir), ATOL)


def test_clip_score_modular_matches_jax(tiny_clip_dir):
    """The per-batch ``forward`` values, the fold of two replicas and the epoch compute."""
    batches = [(_images(10 + i, 2), CAPTIONS[2 * i: 2 * i + 2]) for i in range(3)]
    port, ref = tm.CLIPScore(tiny_clip_dir, device="cpu"), jm.CLIPScore(tiny_clip_dir)
    for i, (imgs, caps) in enumerate(batches):
        assert_close(port(torch.from_numpy(imgs), caps), ref(jnp.asarray(imgs), caps), ATOL, msg=f"forward {i}")
    assert port.n_samples.dtype == torch.int32 and int(port.n_samples) == 6
    epoch = ref.compute()
    assert_close(port.compute(), epoch, ATOL, msg="compute")
    pa, pb = tm.CLIPScore(tiny_clip_dir, device="cpu"), tm.CLIPScore(tiny_clip_dir, device="cpu")
    for i, (imgs, caps) in enumerate(batches):
        (pa if i < 1 else pb).update(torch.from_numpy(imgs), caps)
    pa.merge_state(pb)
    assert_close(pa.compute(), epoch, ATOL, msg="merged")


def test_embed_fn_injection_matches_jax():
    rng = np.random.default_rng(3)
    img_f, txt_f = rng.standard_normal((2, 5, 6)).astype(np.float32)
    txt_f[1] = -img_f[1]  # a negative pair: the mean clamps, the per-pair scores do not
    calls = []

    def port_embed(images, text):
        calls.append((len(images), list(text)))
        return torch.from_numpy(img_f[: len(images)]), torch.from_numpy(txt_f[: len(text)])

    def jax_embed(images, text):
        return jnp.asarray(img_f[: len(images)]), jnp.asarray(txt_f[: len(text)])

    imgs = _images(4, 5, (8, 8))
    for n in (5, 2):
        assert_close(tF.clip_score(torch.from_numpy(imgs[:n]), CAPTIONS[:n], embed_fn=port_embed, device="cpu"),
                     jF.clip_score(jnp.asarray(imgs[:n]), CAPTIONS[:n], embed_fn=jax_embed), ATOL, msg=str(n))
    assert calls[0] == (5, CAPTIONS[:5])
    port = tm.CLIPScore(embed_fn=port_embed, device="cpu")
    ref = jm.CLIPScore(embed_fn=jax_embed)
    assert port.model is None and port.processor is None
    port.update(torch.from_numpy(imgs), CAPTIONS[:5])
    ref.update(jnp.asarray(imgs), CAPTIONS[:5])
    assert_close(port.compute(), ref.compute(), ATOL)
    neg = tm.CLIPScore(embed_fn=lambda i, t: (torch.ones(1, 2), -torch.ones(1, 2)), device="cpu")
    neg.update(torch.from_numpy(imgs[:1]), ["a"])
    assert float(neg.compute()) == 0.0 and float(neg.score) == pytest.approx(-100.0)


def test_uncached_checkpoint_fails_cleanly(monkeypatch):
    def raise_not_cached(*args, **kwargs):
        raise OSError("We couldn't connect to 'https://huggingface.co' to load the files, and couldn't find them in the cached files.")

    _get_model_and_processor.cache_clear()
    monkeypatch.setattr(transformers.CLIPModel, "from_pretrained", raise_not_cached)
    monkeypatch.setattr(transformers.CLIPProcessor, "from_pretrained", raise_not_cached)
    for call in (
        lambda: tF.clip_score(torch.zeros((3, 32, 32), dtype=torch.uint8), "a photo", device="cpu"),
        lambda: tm.CLIPScore(device="cpu"),
        lambda: jF.clip_score(jnp.zeros((3, 32, 32), dtype=jnp.uint8), "a photo"),
    ):
        with pytest.raises(ModuleNotFoundError, match="cached") as err:
            call()
        assert "openai/clip-vit-large-patch14" in str(err.value)


def test_input_errors_as_in_jax():
    embed = lambda i, t: (torch.ones(len(i), 2), torch.ones(len(t), 2))  # noqa: E731
    jembed = lambda i, t: (jnp.ones((len(i), 2)), jnp.ones((len(t), 2)))  # noqa: E731
    for imgs, text in ((np.zeros((2, 3, 4, 4, 1)), ["a", "b"]), (np.zeros((2, 3, 4, 4)), ["a"]),
                       ([np.zeros((3, 4, 4)), np.zeros((4, 4))], ["a", "b"])):
        port_imgs = [torch.from_numpy(x) for x in imgs] if isinstance(imgs, list) else torch.from_numpy(imgs)
        jax_imgs = [jnp.asarray(x) for x in imgs] if isinstance(imgs, list) else jnp.asarray(imgs)
        with pytest.raises(ValueError) as want:
            jF.clip_score(jax_imgs, text, embed_fn=jembed)
        with pytest.raises(ValueError) as got:
            tF.clip_score(port_imgs, text, embed_fn=embed, device="cpu")
        assert str(got.value) == str(want.value)


def test_state_carried_in_from_jax():
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, 2, 4, 6)).astype(np.float32)
    imgs = _images(6, 4, (8, 8))
    ref = jm.CLIPScore(embed_fn=lambda i, t: tuple(jnp.asarray(f[: len(i)]) for f in feats[len(t) - 2]))
    port = tm.CLIPScore(embed_fn=lambda i, t: tuple(torch.from_numpy(f[: len(i)]) for f in feats[len(t) - 2]),
                        device="cpu")
    ref.persistent(True)
    ref.update(jnp.asarray(imgs[:2]), CAPTIONS[:2])
    ref.update(jnp.asarray(imgs[:3]), CAPTIONS[:3])
    port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
    assert port.update_count == 2 and port.n_samples.dtype == torch.int32 and int(port.n_samples) == 5
    ref.update(jnp.asarray(imgs), CAPTIONS[:4])
    port.update(torch.from_numpy(imgs), CAPTIONS[:4])
    assert_close(port.compute(), ref.compute(), ATOL)


def test_engine_falls_back_on_captions():
    """Captions are strings: every update under the engine is an eager fallback, as
    phase 22 of ``chip_smoke.py`` asserts, and equal to the eager run."""
    from torchmetrics_tpu_torch.engine import engine_context

    embed = lambda i, t: (torch.arange(len(i) * 3.0).reshape(-1, 3), torch.ones(len(t), 3))  # noqa: E731
    imgs = torch.from_numpy(_images(7, 2, (8, 8)))
    with engine_context(True):
        port = tm.CLIPScore(embed_fn=embed, device="cpu")
        for _ in range(3):
            port.update(imgs, CAPTIONS[:2])
    eager = tm.CLIPScore(embed_fn=embed, device="cpu", compiled_update=False)
    for _ in range(3):
        eager.update(imgs, CAPTIONS[:2])
    st = port._engine.stats
    assert dict(st.fallback_reasons) == {chip_smoke.AUDIO_FALLBACK_REASONS["clip"]: 3} and st.dispatches == 0
    assert torch.equal(port.compute(), eager.compute())


def test_towers_are_shared_never_copied_or_moved(tiny_clip_dir):
    a = tm.CLIPScore(tiny_clip_dir, device="cpu")
    model = a.model
    assert next(model.parameters()).device.type == "cpu" and not model.training
    b = a.clone()
    assert b.model is model and copy.deepcopy(a).model is model
    assert pickle.loads(pickle.dumps(a)).model is model
    assert "model" not in dict(a.named_children()) and not list(a.parameters())
    assert a.processor is _get_model_and_processor(tiny_clip_dir)[1]


def test_exports_and_docstring_examples():
    assert ttm.CLIPScore is tm.CLIPScore and ttm.functional.clip_score is tF.clip_score
    assert set(tm.__all__) == set(jm.__all__) and set(tF.__all__) == set(jF.__all__)
    for module in ("torchmetrics_tpu_torch.functional.multimodal.clip_score", "torchmetrics_tpu_torch.multimodal.clip_score"):
        results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
        assert results.attempted and not results.failed, module
