"""SSIM and MS-SSIM: the port (on the CPU) against the JAX package.

Modular at the three protocol levels of ``tests/differential/harness.py``
(``torch_parity``) on seeded batches of 2 x 3 x 32 x 32 images (MS-SSIM: three betas
on 48 x 48), one kwarg set per option: ``data_range`` ``None`` / float / tuple,
``gaussian_kernel=False``, ``return_full_image``, ``return_contrast_sensitivity``, the
three reductions and MS-SSIM's ``normalize`` ``None`` / ``"relu"`` / ``"simple"``.
Functionally: 3-D with an anisotropic ``sigma`` (each axis padded and cropped by its
own gaussian size), a reflect pad wider than the image (compared through
``return_full_image``'s map; the cropped mean is NaN in both packages) and the default
five-scale MS-SSIM at 176 x 176, the least size its check allows. The band matrices
are bit-equal to the JAX package's ``_band_matrix_np`` cast to float32, the reflect pad
equal to ``numpy.pad(mode="reflect")`` at every size, and the engine's replay /
fallback split equal to the JAX engine's.

Tolerances: values absolute 1e-5 (``ATOL``); the float sum states (the JAX side's are
float64 under x64) absolute 1e-5.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.image as jF
import torchmetrics_tpu.image as ji
import torchmetrics_tpu_torch.functional.image as tF
import torchmetrics_tpu_torch.image as ti
from tests.torch_parity import assert_close, engine_split, three_levels_args
from torchmetrics_tpu.functional.image.helper import _band_matrix_np as jax_band_matrix_np
from torchmetrics_tpu.functional.image.helper import _gaussian_np as jax_gaussian_np
from torchmetrics_tpu_torch.functional.image import helper

ATOL = 1e-5
SHAPE = (2, 3, 32, 32)
MS_SHAPE = (2, 3, 48, 48)
MS_BETAS = (0.3, 0.3, 0.4)
SIZES = (2, 2, 2)  # images per update: one shape, so the JAX side compiles each operation once


def _images(seed: int, shape, n: int = len(SIZES)) -> list:
    """Smooth-ish targets in [0, 1] and noised, scaled predictions, float32."""
    rng = np.random.default_rng(seed)
    out = []
    for b in SIZES[:n]:
        target = rng.random((b, *shape[1:])).astype(np.float32)
        target = (target + np.roll(target, 1, -1) + np.roll(target, 1, -2)) / 3
        preds = np.clip(0.8 * target + 0.1 + 0.05 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
        out.append((preds, target))
    return out


SSIM_CASES = [
    {},
    {"data_range": 1.0, "reduction": "sum"},
    {"gaussian_kernel": False, "kernel_size": 7, "data_range": (0.1, 0.9)},
    {"data_range": 1.0, "return_full_image": True},
    {"data_range": 1.0, "return_contrast_sensitivity": True, "reduction": "none"},
]


@pytest.mark.parametrize("kwargs", SSIM_CASES, ids=[str(k) for k in SSIM_CASES])
def test_ssim_modular(kwargs):
    three_levels_args(
        lambda: ti.StructuralSimilarityIndexMeasure(**kwargs, device="cpu"),
        lambda: ji.StructuralSimilarityIndexMeasure(**kwargs),
        [(b, b) for b in _images(0, SHAPE)],
        ATOL, float_state_atol=ATOL,
    )


MS_CASES = [
    {"kernel_size": 7},
    {"data_range": 1.0, "normalize": "simple", "reduction": "sum"},
    {"data_range": (0.0, 1.0), "normalize": None, "reduction": "none", "gaussian_kernel": False, "kernel_size": 5},
]


@pytest.mark.parametrize("kwargs", MS_CASES, ids=[str(k) for k in MS_CASES])
def test_ms_ssim_modular(kwargs):
    three_levels_args(
        lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(betas=MS_BETAS, **kwargs, device="cpu"),
        lambda: ji.MultiScaleStructuralSimilarityIndexMeasure(betas=MS_BETAS, **kwargs),
        [(b, b) for b in _images(1, MS_SHAPE)],
        ATOL, float_state_atol=ATOL,
    )


def _both(fn: str, *arrays, **kwargs):
    """The port's functional and the JAX package's (jitted: one compile, not one per
    operation) on the same arrays."""
    port = getattr(tF, fn)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    ref = jax.jit(functools.partial(getattr(jF, fn), **kwargs))(*[jnp.asarray(a) for a in arrays])
    return port, ref


def test_ssim_3d_anisotropic_sigma():
    """Each axis of a 2 x 1 x 12 x 16 x 20 volume is padded and cropped by its own
    gaussian size (11, 9 and 5 taps), although the JAX call names the pads out of order."""
    rng = np.random.default_rng(2)
    target = rng.random((2, 1, 12, 16, 20)).astype(np.float32)
    preds = np.clip(target * 0.9 + 0.05 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    for kwargs in ({"sigma": (1.5, 1.0, 0.7)}, {"sigma": (1.5, 1.0, 0.7), "return_full_image": True, "data_range": 1.0},
                   {"sigma": (0.7, 1.5, 1.0), "gaussian_kernel": False, "kernel_size": (3, 5, 7), "reduction": "none"}):
        port, ref = _both("structural_similarity_index_measure", preds, target, **kwargs)
        assert_close(port, ref, ATOL, msg=str(kwargs))
    port, ref = _both("multiscale_structural_similarity_index_measure", preds, target,
                      sigma=(1.5, 1.0, 0.7), kernel_size=(3, 3, 3), betas=(0.5, 0.5), data_range=1.0)
    assert_close(port, ref, ATOL, msg="ms-ssim 3-D")


def test_reflect_pad_wider_than_the_image():
    """An 11-tap window pads 5 on each side of 4 x 5 images: numpy reflects again, the
    cropped map is empty and its mean NaN in both packages; the full maps agree."""
    preds, target = _images(3, (2, 2, 4, 5))[0]
    port, ref = _both("structural_similarity_index_measure", preds, target, data_range=1.0,
                      return_full_image=True, reduction="none")
    assert np.isnan(port[0].numpy()).all() and np.isnan(np.asarray(ref[0])).all()
    assert port[1].shape == (2, 2, 4, 5) and np.isfinite(port[1].numpy()).all()
    assert_close(port[1], ref[1], ATOL, msg="full map")


def test_ms_ssim_default_five_scales():
    """The default betas and kernel at 176 x 176, the least size their check allows."""
    preds, target = _images(4, (1, 1, 176, 176), n=1)[0]
    port, ref = _both("multiscale_structural_similarity_index_measure", preds, target)
    assert_close(port, ref, ATOL, msg="five scales")
    with pytest.raises(ValueError, match="larger than 160"):
        tF.multiscale_structural_similarity_index_measure(torch.from_numpy(preds[..., :160, :160]),
                                                          torch.from_numpy(target[..., :160, :160]))


@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
def test_ms_ssim_normalize_on_dissimilar_images(normalize):
    """Unrelated images give negative contrast sensitivities: ``relu`` clips them,
    ``simple`` maps them to [0, 1], ``None`` takes them to fractional powers (NaN)."""
    rng = np.random.default_rng(5)
    preds, target = (rng.random(MS_SHAPE).astype(np.float32) for _ in range(2))
    port, ref = _both("multiscale_structural_similarity_index_measure", preds, target, betas=MS_BETAS,
                      normalize=normalize, reduction="none", data_range=1.0)
    assert_close(port, ref, ATOL, msg=str(normalize))


@pytest.mark.parametrize("taps", [("gauss", 11, 1.5), ("gauss", 9, 1.0), ("gauss", 5, 0.7), ("uniform", 7), ("uniform", 8)])
@pytest.mark.parametrize("n_in", [16, 42, 266])
def test_band_matrix_bit_equal_to_the_jax_package(taps, n_in):
    kernel = jax_gaussian_np(*taps[1:]) if taps[0] == "gauss" else np.full(taps[1], 1.0 / taps[1])
    ours = helper._gaussian_np(*taps[1:]) if taps[0] == "gauss" else helper._uniform_np(taps[1])
    np.testing.assert_array_equal(ours, kernel)
    want = jax_band_matrix_np(kernel, n_in).astype(np.float32)
    got = helper._band(ours, n_in, torch.float32, torch.device("cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert helper._band(ours, n_in, torch.float32, torch.device("cpu")) is got  # cached


def test_reflect_pad_equals_numpy_at_every_size():
    x = torch.arange(2 * 13, dtype=torch.float32).reshape(2, 13)
    for n in range(1, 14):
        for pad in range(0, 3 * n + 2):
            got = helper._reflect_pad(x[:, :n], (pad,))
            want = np.pad(x[:, :n].numpy(), ((0, 0), (pad, pad)), mode="reflect")
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n={n} pad={pad}")


def test_engine_split():
    """Sum states replay; a ``none`` reduction's list falls back, as in the JAX package."""
    batches = [(b, b) for b in _images(6, SHAPE)]
    for kwargs, replays in (({}, 3), ({"reduction": "none"}, 0), ({"data_range": 1.0, "reduction": "sum"}, 3)):
        st = engine_split(lambda: ti.StructuralSimilarityIndexMeasure(**kwargs, device="cpu"),
                          lambda: ji.StructuralSimilarityIndexMeasure(**kwargs), batches)
        assert st.dispatches == replays, kwargs
    ms = [(b, b) for b in _images(7, MS_SHAPE)]
    st = engine_split(lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(betas=MS_BETAS, device="cpu"),
                      lambda: ji.MultiScaleStructuralSimilarityIndexMeasure(betas=MS_BETAS), ms)
    assert st.dispatches == 3 and st.eager_fallbacks == 0


def test_update_copies_nothing_from_the_host():
    """The guard of the engine's first step refuses a host copy: after the caches are
    cold, a guarded SSIM and MS-SSIM update still replays (bands and gather indices are
    made on the device by fills and ``arange``)."""
    from torchmetrics_tpu_torch.engine import engine_context

    helper._CONSTANTS.clear()
    (preds, target), = _images(8, (2, 1, 24, 40), n=1)
    with engine_context(True):
        m = ti.StructuralSimilarityIndexMeasure(device="cpu")
        for _ in range(2):
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert m._engine.stats.dispatches == 2 and not m._engine.stats.eager_fallbacks


def test_input_errors():
    x = torch.rand(1, 1, 16, 16)
    errors = [
        (ValueError, lambda: tF.structural_similarity_index_measure(x[0], x[0])),
        (RuntimeError, lambda: tF.structural_similarity_index_measure(x, x[..., :8])),
        (ValueError, lambda: tF.structural_similarity_index_measure(x, x, kernel_size=4)),
        (ValueError, lambda: tF.structural_similarity_index_measure(x, x, kernel_size=(3, 3, 3))),
        (ValueError, lambda: tF.structural_similarity_index_measure(x, x, sigma=(1.5, -1.0))),
        (ValueError, lambda: tF.structural_similarity_index_measure(x, x, return_full_image=True,
                                                                    return_contrast_sensitivity=True)),
        (ValueError, lambda: tF.multiscale_structural_similarity_index_measure(x, x, betas=(1, 2))),
        (ValueError, lambda: tF.multiscale_structural_similarity_index_measure(x, x, normalize="tanh")),
        (ValueError, lambda: tF.multiscale_structural_similarity_index_measure(x, x)),
        (ValueError, lambda: ti.StructuralSimilarityIndexMeasure(reduction="mean", device="cpu")),
        (ValueError, lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=(3, 3, 3, 3), device="cpu")),
        (ValueError, lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(betas=[0.5], device="cpu")),
        (ValueError, lambda: ti.MultiScaleStructuralSimilarityIndexMeasure(normalize="tanh", device="cpu")),
    ]
    for i, (exc, call) in enumerate(errors):
        with pytest.raises(exc):
            call()
    # the JAX package raises the same on the same calls
    j = jnp.asarray(x.numpy())
    with pytest.raises(ValueError, match="odd positive"):
        jF.structural_similarity_index_measure(j, j, kernel_size=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="odd positive"):
            tF.structural_similarity_index_measure(x, x, kernel_size=4)
