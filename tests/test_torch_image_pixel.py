"""The other image metrics: the port (on the CPU) against the JAX package.

PSNR, PSNR-B, RMSE-SW, RASE, UQI, D-lambda, ERGAS, SAM, TV and the image gradients,
modular at the three protocol levels of ``tests/differential/harness.py``
(``torch_parity``) on seeded batches of 2 x 3 x 16 x 16 images (PSNR-B: 2 x 1 x 30 x 27
luma, not a multiple of its block), and functionally: PSNR with ``dim``, ``base`` and
the reductions, RMSE-SW and RASE with ``window_size=1`` (NaN in both packages),
D-lambda with C = 1 and p = 2, TV with ``none``. A state carried in from the JAX
package through ``interop.state_from_jax`` finishes the epoch in the port (SSIM and
PSNR); the input checks raise what the JAX package raises; the engine's replay /
fallback split equals the JAX engine's.

Tolerances: UQI and D-lambda absolute 1e-5 (``ATOL``); PSNR, PSNR-B, ERGAS, RASE,
RMSE-SW and SAM relative 1e-5 (``RTOL``); TV and the gradients exact on
integer-valued images, relative 1e-6 (``TV_RTOL``) otherwise. The JAX side's float
states are float64 under x64: float sum states within relative 1e-5.
"""

from __future__ import annotations

import doctest
import functools
import importlib
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.functional.image as jF
import torchmetrics_tpu.image as ji
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.functional.image as tF
import torchmetrics_tpu_torch.image as ti
from tests.torch_parity import assert_close, engine_split, three_levels_args
from torchmetrics_tpu_torch.interop import state_from_jax

ATOL = 1e-5
RTOL = 1e-5
TV_RTOL = 1e-6
SHAPE = (2, 3, 16, 16)
LUMA = (2, 1, 30, 27)
N_UPDATES = 3


def _images(seed: int, shape=SHAPE, n: int = N_UPDATES, integer: bool = False) -> list:
    """``(preds, target)`` float32 batches: targets in [0.05, 1], predictions a noised,
    scaled copy (integer-valued 0-255 images when ``integer``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if integer:
            target = rng.integers(0, 256, shape).astype(np.float32)
            preds = np.clip(target + rng.integers(-20, 21, shape), 0, 255).astype(np.float32)
        else:
            target = (0.05 + 0.95 * rng.random(shape)).astype(np.float32)
            preds = np.clip(0.8 * target + 0.1 + 0.05 * rng.standard_normal(shape), 0, 1).astype(np.float32)
        out.append((preds, target))
    return out


# (class, kwargs, input shape, (atol, rtol))
CASES = [
    ("PeakSignalNoiseRatio", {}, SHAPE, (0.0, RTOL)),
    ("PeakSignalNoiseRatio", {"data_range": (0.1, 0.9), "base": 2.0}, SHAPE, (0.0, RTOL)),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, SHAPE, (0.0, RTOL)),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, LUMA, (0.0, RTOL)),
    ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 4}, LUMA, (0.0, RTOL)),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, SHAPE, (0.0, RTOL)),
    ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 1}, SHAPE, (0.0, RTOL)),
    ("RelativeAverageSpectralError", {}, SHAPE, (0.0, RTOL)),
    ("RelativeAverageSpectralError", {"window_size": 1}, SHAPE, (0.0, RTOL)),
    ("UniversalImageQualityIndex", {}, SHAPE, (ATOL, 0.0)),
    ("UniversalImageQualityIndex", {"kernel_size": (5, 7), "sigma": (1.0, 2.0), "reduction": "none"}, SHAPE, (ATOL, 0.0)),
    ("SpectralDistortionIndex", {}, SHAPE, (ATOL, 0.0)),
    ("SpectralDistortionIndex", {"p": 2, "reduction": "none"}, SHAPE, (ATOL, 0.0)),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, SHAPE, (0.0, RTOL)),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2, "reduction": "none"}, SHAPE, (0.0, RTOL)),
    ("SpectralAngleMapper", {}, SHAPE, (0.0, RTOL)),
    ("SpectralAngleMapper", {"reduction": "sum"}, SHAPE, (0.0, RTOL)),
]
_IDS = [f"{name}-{kw}" for name, kw, _, _ in CASES]


@pytest.mark.parametrize("name, kwargs, shape, tol", CASES, ids=_IDS)
def test_modular(name, kwargs, shape, tol):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # empty crops (window_size=1) warn in both packages
        three_levels_args(
            lambda: getattr(ti, name)(**kwargs, device="cpu"),
            lambda: getattr(ji, name)(**kwargs),
            [(b, b) for b in _images(0, shape)],
            *tol, float_state_rtol=RTOL,
        )


@pytest.mark.parametrize("kwargs, integer", [({}, True), ({"reduction": "mean"}, False), ({"reduction": "none"}, True)])
def test_total_variation_modular(kwargs, integer):
    """Exact on integer-valued images (every partial sum an integer below 2^24)."""
    rtol = 0.0 if integer else TV_RTOL
    three_levels_args(
        lambda: ti.TotalVariation(**kwargs, device="cpu"),
        lambda: ji.TotalVariation(**kwargs),
        [((p,), (p,)) for p, _ in _images(1, integer=integer)],
        0.0, rtol, float_state_rtol=rtol,
    )


def _both(fn: str, *arrays, **kwargs):
    """The port's functional and the JAX package's (jitted: one compile, not one per
    operation) on the same arrays."""
    port = getattr(tF, fn)(*[torch.from_numpy(a) for a in arrays], **kwargs)
    ref = jax.jit(functools.partial(getattr(jF, fn), **kwargs))(*[jnp.asarray(a) for a in arrays])
    return port, ref


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"data_range": 1.0, "dim": 1, "reduction": "none"}, {"data_range": 1.0, "dim": (2, 3), "reduction": "sum"},
     {"data_range": (0.2, 0.8), "dim": (1, 2, 3), "base": 2.0}, {"data_range": 1.0, "dim": ()}, {"base": np.e}],
    ids=str,
)
def test_psnr_functional(kwargs):
    (preds, target), = _images(2, n=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref = _both("peak_signal_noise_ratio", preds, target, **kwargs)
    assert_close(port, ref, 0.0, RTOL, str(kwargs))


def test_psnr_reduction_without_dim_warns():
    (preds, target), = _images(2, n=1)
    with pytest.warns(UserWarning, match="will not have any effect"):
        tF.peak_signal_noise_ratio(torch.from_numpy(preds), torch.from_numpy(target), reduction="sum")


def test_psnrb_functional_and_multichannel_error():
    (preds, target), = _images(3, shape=(3, 1, 37, 21), n=1)
    for block_size in (8, 5):
        port, ref = _both("peak_signal_noise_ratio_with_blocked_effect", preds, target, block_size=block_size)
        assert_close(port, ref, 0.0, RTOL, f"block {block_size}")
    # a data range above 2 takes the other branch
    port, ref = _both("peak_signal_noise_ratio_with_blocked_effect", preds * 255, target * 255)
    assert_close(port, ref, 0.0, RTOL, "0-255")
    rgb = torch.rand(1, 3, 16, 16)
    for call in (lambda: tF.peak_signal_noise_ratio_with_blocked_effect(rgb, rgb),
                 lambda: ti.PeakSignalNoiseRatioWithBlockedEffect(device="cpu").update(rgb, rgb)):
        with pytest.raises(ValueError, match="grayscale"):
            call()
    with pytest.raises(ValueError, match="grayscale"):
        jF.peak_signal_noise_ratio_with_blocked_effect(jnp.asarray(rgb.numpy()), jnp.asarray(rgb.numpy()))


@pytest.mark.parametrize("window_size", [1, 2, 5, 8])
def test_windowed_functionals(window_size):
    """RMSE-SW (value and map) and RASE; ``window_size=1`` crops ``[0:-0]``: NaN in both."""
    (preds, target), = _images(4, n=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port, ref = _both("root_mean_squared_error_using_sliding_window", preds, target, window_size=window_size,
                          return_rmse_map=True)
        assert_close(port, ref, 0.0, RTOL, f"rmse_sw {window_size}")
        port, ref = _both("relative_average_spectral_error", preds, target, window_size=window_size)
        assert_close(port, ref, 0.0, RTOL, f"rase {window_size}")
    assert np.isnan(float(port)) == (window_size == 1)


@pytest.mark.parametrize("p, channels", [(1, 1), (2, 1), (2, 3), (3, 4)])
def test_d_lambda_functional(p, channels):
    (preds, target), = _images(5, shape=(2, channels, 16, 16), n=1)
    for reduction in ("elementwise_mean", "none"):
        port, ref = _both("spectral_distortion_index", preds, target, p=p, reduction=reduction)
        assert_close(port, ref, ATOL, msg=f"p={p} C={channels} {reduction}")
    if channels == 1:
        assert float(port.sum()) == 0.0


def test_uqi_ergas_sam_functionals():
    """A ``sum`` over the UQI map adds 1536 float32 terms in another order: held to
    ``ATOL`` per term. SAM's per-pixel angles are arccos of float32 cosines near 1, whose
    condition number is 1 / sin(angle): held to four float32 ulps of the cosine (a dot
    product over two norms, rounded in another order) through it, beside ``RTOL``."""
    (preds, target), = _images(6, n=1)
    for fn, kwargs, tol in (
        ("universal_image_quality_index", {"reduction": "none"}, (ATOL, 0.0)),
        ("universal_image_quality_index", {"kernel_size": (3, 9), "sigma": (0.5, 3.0)}, (ATOL, 0.0)),
        ("universal_image_quality_index", {"reduction": "sum"}, (ATOL * preds.size, 0.0)),
        ("error_relative_global_dimensionless_synthesis", {"ratio": 0.25, "reduction": "sum"}, (0.0, RTOL)),
        ("spectral_angle_mapper", {"reduction": "sum"}, (0.0, RTOL)),
    ):
        port, ref = _both(fn, preds, target, **kwargs)
        assert_close(port, ref, *tol, f"{fn} {kwargs}")
    port, ref = _both("spectral_angle_mapper", preds, target, reduction="none")
    ref = np.asarray(ref)
    tol = RTOL * np.abs(ref) + 4 * 2.0**-24 / np.sin(ref)
    assert port.shape == ref.shape and (np.abs(port.numpy() - ref) <= tol).all()


@pytest.mark.parametrize("integer", [True, False])
def test_total_variation_and_gradients_functional(integer):
    (img, _), = _images(7, n=1, integer=integer)
    rtol = 0.0 if integer else TV_RTOL
    for reduction in ("sum", "mean", "none", None):
        port, ref = _both("total_variation", img, reduction=reduction)
        assert_close(port, ref, 0.0, rtol, f"tv {reduction}")
    port, ref = _both("image_gradients", img)
    assert_close(port, ref, 0.0, rtol, "gradients")


def test_state_carried_in_from_jax():
    """SSIM and PSNR: two updates in the JAX package, its state dict through
    ``state_from_jax`` into the port, one more update on each side: equal computes."""
    batches = _images(8, n=3)
    for make_port, make_ref, atol, rtol in (
        (lambda: ti.StructuralSimilarityIndexMeasure(device="cpu"), ji.StructuralSimilarityIndexMeasure, ATOL, 0.0),
        (lambda: ti.PeakSignalNoiseRatio(device="cpu"), ji.PeakSignalNoiseRatio, 0.0, RTOL),
        (lambda: ti.PeakSignalNoiseRatio(data_range=1.0, device="cpu"), lambda: ji.PeakSignalNoiseRatio(data_range=1.0),
         0.0, RTOL),
    ):
        ref, port = make_ref(), make_port()
        ref.persistent(True)
        for preds, target in batches[:2]:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
        assert port.update_count == 2
        preds, target = batches[2]
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(port.compute(), ref.compute(), atol, rtol, type(port).__name__)


def test_engine_split():
    """The sum-state metrics replay, the ``cat`` lists fall back: as in the JAX package."""
    batches = [(b, b) for b in _images(9)]
    luma = [(b, b) for b in _images(9, shape=LUMA)]
    for name, kwargs, data, replays in (
        ("PeakSignalNoiseRatio", {}, batches, 3),
        ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": 1}, batches, 0),
        ("PeakSignalNoiseRatioWithBlockedEffect", {}, luma, 3),
        ("RootMeanSquaredErrorUsingSlidingWindow", {}, batches, 3),
        ("UniversalImageQualityIndex", {}, batches, 0),
        ("SpectralAngleMapper", {}, batches, 0),
    ):
        st = engine_split(lambda: getattr(ti, name)(**kwargs, device="cpu"), lambda: getattr(ji, name)(**kwargs), data)
        assert st.dispatches == replays, (name, kwargs)
    imgs = [((p,), (p,)) for p, _ in _images(9)]
    for kwargs, replays in (({}, 3), ({"reduction": "none"}, 0)):
        st = engine_split(lambda: ti.TotalVariation(**kwargs, device="cpu"), lambda: ji.TotalVariation(**kwargs), imgs)
        assert st.dispatches == replays, kwargs


def _raises_like_jax(port_call, jax_call) -> None:
    """The port raises the exception type the JAX package raises, with the same message
    (dtypes and shapes written as each framework writes them: ``float16`` and
    ``torch.float16``, ``(2, 3)`` and ``torch.Size([2, 3])``)."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    message = re.sub(r"Size\(\[([^\]]*)\]\)", r"(\1)", str(got.value).replace("torch.", ""))
    assert message.replace("Tensor", "Array") == str(want.value)


def test_input_errors():
    x = np.random.default_rng(10).random(SHAPE).astype(np.float32)
    half = x.astype(np.float16)
    gray = x[:, :1]
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        ("universal_image_quality_index", (x, half), {}),
        ("universal_image_quality_index", (x, x[..., :8]), {}),
        ("universal_image_quality_index", (x[0], x[0]), {}),
        ("universal_image_quality_index", (x, x), {"kernel_size": (4, 5)}),
        ("universal_image_quality_index", (x, x), {"sigma": (1.0, 0.0)}),
        ("universal_image_quality_index", (x, x), {"kernel_size": (3, 3, 3)}),
        ("spectral_distortion_index", (x, half), {}),
        ("spectral_distortion_index", (x, x), {"p": 0}),
        ("error_relative_global_dimensionless_synthesis", (x, half), {}),
        ("error_relative_global_dimensionless_synthesis", (x[0], x[0]), {}),
        ("spectral_angle_mapper", (gray, gray), {}),
        ("spectral_angle_mapper", (x, half), {}),
        ("root_mean_squared_error_using_sliding_window", (x, x), {"window_size": 0}),
        ("root_mean_squared_error_using_sliding_window", (x, x), {"window_size": 40}),
        ("root_mean_squared_error_using_sliding_window", (x, half), {}),
        ("relative_average_spectral_error", (x, x), {"window_size": -1}),
        ("peak_signal_noise_ratio", (x, x), {"dim": 1}),
        ("total_variation", (x[0],), {}),
        ("total_variation", (x,), {"reduction": "max"}),
        ("image_gradients", (x[0],), {}),
    ]
    for fn, arrays, kwargs in pairs:
        _raises_like_jax(lambda: getattr(tF, fn)(*map(t, arrays), **kwargs),
                         lambda: getattr(jF, fn)(*map(j, arrays), **kwargs))
    with pytest.raises(TypeError):
        tF.image_gradients(x)
    modular = [
        ("SpectralDistortionIndex", {"p": 1.5}), ("SpectralDistortionIndex", {"reduction": "max"}),
        ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 0}), ("RelativeAverageSpectralError", {"window_size": 0}),
        ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 0}), ("PeakSignalNoiseRatio", {"dim": 1}),
        ("TotalVariation", {"reduction": "max"}),
    ]
    for name, kwargs in modular:
        _raises_like_jax(lambda: getattr(ti, name)(**kwargs, device="cpu"), lambda: getattr(ji, name)(**kwargs))


# exported at the root as they are (no deprecated alias), as in the JAX package
_DIRECT_AT_ROOT = {
    "PeakSignalNoiseRatioWithBlockedEffect", "FrechetInceptionDistance", "InceptionScore", "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
}


def test_root_aliases_warn_and_domain_imports_do_not():
    names = [n for n in ti.__all__ if n not in _DIRECT_AT_ROOT]
    assert len(names) == 10 and set(ti.__all__) <= set(ttm.__all__)
    for name in names:
        with pytest.warns(DeprecationWarning, match=f"torchmetrics_tpu_torch.image.{name}"):
            alias = getattr(ttm, name)(device="cpu")
        assert isinstance(alias, getattr(ti, name))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            getattr(ti, name)(device="cpu")
    for name in _DIRECT_AT_ROOT:
        assert getattr(ttm, name) is getattr(ti, name)
    assert set(ti.__all__) == set(ji.__all__)
    assert set(tF.__all__) == set(jF.__all__)
    assert {n for n in jtm.__all__ if n in ji.__all__} <= set(ttm.__all__)


@pytest.mark.parametrize(
    "module",
    [f"torchmetrics_tpu_torch.functional.image.{m}" for m in
     ("ssim", "uqi", "d_lambda", "psnr", "psnrb", "rmse_sw", "rase", "ergas", "sam", "tv", "gradients")]
    + [f"torchmetrics_tpu_torch.image.{m}" for m in
       ("ssim", "psnr", "psnrb", "rmse_sw", "tv", "uqi", "d_lambda", "ergas", "sam", "rase")],
)
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
