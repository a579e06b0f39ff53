"""The feature trunks, their weights and their files: the port (on the CPU) against the
JAX package.

Each trunk runs on the same weights in both packages, brought in two ways: a seeded
torchvision-layout state dict (``tests/image/torch_mirrors.seeded_state_dict``: every
parameter and batch-norm statistic random, so a swapped mean / variance or a wrong
epsilon shows), loaded into the port with ``load_state_dict`` as it is and into the JAX
trunk with ``from_fidelity_state_dict`` / ``from_torch_state_dict``; and the JAX
package's flax variables (numpy leaves) carried into the port by
``state_dict_from_flax``. The FID trunk's six taps come from one jitted JAX apply per
module (its compile is the cost of this file). Also: the TF1 resize matrices bit-equal
to the JAX package's, the ``.npz`` format read and written by both, the bundled LPIPS
heads byte-equal to the JAX package's file, the seeded default init, and the TF32 flags.

Tolerances: taps relative 1e-4 plus absolute 1e-5 of the tap's scale (float32
convolutions in other orders through ~47 layers; under x64 the JAX FID trunk's
``count_include_pad=False`` pools promote its later blocks to float64), the LPIPS
backbones absolute 1e-5, a resize absolute 1e-4 on values in [0, 255].
"""

from __future__ import annotations

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.image.torch_mirrors import seeded_state_dict
from torchmetrics_tpu.models import alexnet as jalex
from torchmetrics_tpu.models import inception as jinc
from torchmetrics_tpu.models import serialization as jser
from torchmetrics_tpu.models import squeezenet as jsq
from torchmetrics_tpu.models import vgg as jvgg
from torchmetrics_tpu_torch import models as tmodels
from torchmetrics_tpu_torch.models import alexnet as talex
from torchmetrics_tpu_torch.models import inception as tinc
from torchmetrics_tpu_torch.models import serialization as tser
from torchmetrics_tpu_torch.models import squeezenet as tsq
from torchmetrics_tpu_torch.models import vgg as tvgg
from torchmetrics_tpu_torch.models._common import default_trunk, load_trunk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAP_RTOL, TAP_ATOL_SCALE, LPIPS_ATOL, RESIZE_ATOL = 1e-4, 1e-5, 1e-5, 1e-4
TAPS = tinc.TAPS


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _float32(sd: dict) -> dict:
    return {k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()}


def _assert_taps(got: dict, want: dict, msg: str = "") -> None:
    for tap in want:
        g, w = got[tap].detach().numpy(), np.asarray(want[tap])
        assert g.shape == w.shape, (tap, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=TAP_RTOL, atol=TAP_ATOL_SCALE * np.abs(w).max(), err_msg=f"{msg} {tap}")


def _trunk_outputs(model, x: torch.Tensor, *args):
    with torch.no_grad():
        return model(x, *args)


@pytest.fixture(scope="module")
def fid_case():
    """A seeded torch-fidelity-layout state dict, its JAX variables, two uint8 images and
    the JAX trunk's six taps on them (one compile)."""
    sd = _float32(seeded_state_dict(default_trunk(tinc.FIDInceptionV3, "cpu"), seed=5))
    variables = jinc.from_fidelity_state_dict({k: v.numpy() for k, v in sd.items()})
    imgs = np.random.default_rng(6).integers(0, 256, (2, 3, 21, 17)).astype(np.uint8)
    model = jinc.FIDInceptionV3(request=TAPS)
    want = jax.jit(model.apply)(variables, jnp.asarray(imgs))
    return sd, _numpy_tree(variables), imgs, {k: np.asarray(v) for k, v in want.items()}


def test_fid_trunk_carried_from_flax(fid_case):
    """The flax variables through ``state_dict_from_flax`` are the state dict they came
    from, bit for bit, and the port's trunk on them gives the JAX trunk's six taps."""
    sd, variables, imgs, want = fid_case
    carried = tinc.state_dict_from_flax(variables)
    assert set(carried) == {k for k in sd if not k.endswith("num_batches_tracked")}
    for k, v in carried.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    model = load_trunk(default_trunk(tinc.FIDInceptionV3, "cpu"), carried)
    _assert_taps(_trunk_outputs(model, torch.from_numpy(imgs), TAPS), want, "carried")


def test_fid_trunk_loads_the_fidelity_layout(fid_case):
    """The torch-fidelity layout loads with a strict ``load_state_dict`` and gives the same
    taps as the JAX trunk on ``from_fidelity_state_dict``; NHWC input reads as NCHW."""
    sd, _, imgs, want = fid_case
    model = default_trunk(tinc.FIDInceptionV3, "cpu")
    model.load_state_dict(sd)
    got = _trunk_outputs(model, torch.from_numpy(imgs), TAPS)
    _assert_taps(got, want, "load_state_dict")
    nhwc = _trunk_outputs(model, torch.from_numpy(imgs).permute(0, 2, 3, 1), TAPS)
    for tap in TAPS:
        torch.testing.assert_close(nhwc[tap], got[tap], rtol=0, atol=0)
    assert set(tinc.from_fidelity_state_dict(sd)) == set(tinc.state_dict_from_flax(fid_case[1]))


def test_fid_extractor_request_contract(fid_case):
    """One tap name gives a tensor, a sequence a tuple in order, an unknown tap raises;
    a trunk without ``fc`` cannot serve logits; ``device=None`` means the card."""
    sd, variables, imgs, want = fid_case
    x = torch.from_numpy(imgs)
    single = tinc.fid_inception_v3_extractor("768", state_dict=sd, device="cpu")
    _assert_taps({"768": single(x)}, {"768": want["768"]}, "single tap")
    multi = tinc.fid_inception_v3_extractor(("logits", "64"), variables=variables, device="cpu")
    logits, f64 = multi(x)
    assert logits.shape == (2, 1008) and f64.shape == (2, 64) and not logits.requires_grad
    with pytest.raises(ValueError, match="subset of"):
        tinc.fid_inception_v3_extractor("1000", state_dict=sd, device="cpu")
    no_fc = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    tinc.fid_inception_v3_extractor("2048", state_dict=no_fc, device="cpu")
    with pytest.raises(KeyError, match="fc.weight"):
        tinc.fid_inception_v3_extractor("logits", state_dict=no_fc, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tinc.fid_inception_v3_extractor("2048", state_dict=sd)


def test_torchvision_inception_v3():
    """torchvision's layout (aux head and 1000-way fc included) loads as it is; the port's
    ``InceptionV3`` on uint8 and float images equals the JAX trunk on
    ``from_torch_state_dict``, and the flax variables carry back bit for bit."""
    sd = _float32(seeded_state_dict(default_trunk(tmodels.InceptionV3, "cpu"), seed=7))
    assert any(k.startswith("AuxLogits.") for k in sd) and sd["fc.weight"].shape == (1000, 2048)
    variables = jinc.from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    imgs = np.random.default_rng(8).integers(0, 256, (2, 3, 75, 75)).astype(np.uint8)
    model = default_trunk(tmodels.InceptionV3, "cpu")
    model.load_state_dict(sd)
    got = _trunk_outputs(model, torch.from_numpy(imgs))
    _assert_taps({"2048": got}, {"2048": jax.jit(jinc.InceptionV3().apply)(variables, jnp.asarray(imgs))})
    # the same images as NHWC floats already divided by 255
    floats = torch.from_numpy(imgs).permute(0, 2, 3, 1).float() / 255.0
    torch.testing.assert_close(_trunk_outputs(model, floats), got, rtol=1e-5, atol=1e-6)
    carried = tinc.state_dict_from_flax(_numpy_tree(variables))
    for k, v in carried.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    extractor = tmodels.inception_v3_extractor(state_dict=sd, device="cpu")
    torch.testing.assert_close(extractor(torch.from_numpy(imgs)), _trunk_outputs(model, torch.from_numpy(imgs)))


_BACKBONES = {
    "alex": (jalex, talex, lambda: jalex.AlexNetFeatures(), talex.AlexNetFeatures, (64, 192, 384, 256, 256)),
    "vgg": (jvgg, tvgg, lambda: jvgg.VGG16Features(apply_scaling=False), lambda: tvgg.VGG16Features(False), (64, 128, 256, 512, 512)),
    "squeeze": (jsq, tsq, lambda: jsq.SqueezeNetFeatures(), tsq.SqueezeNetFeatures, (64, 128, 256, 384, 384, 512, 512)),
}


def _assert_maps(port_maps, jax_maps, dims, msg: str) -> None:
    assert [m.shape[1] for m in port_maps] == list(dims), msg
    for i, (p, j) in enumerate(zip(port_maps, jax_maps)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j).transpose(0, 3, 1, 2), rtol=0, atol=LPIPS_ATOL,
                                   err_msg=f"{msg} tap {i}")


@pytest.mark.parametrize("net", list(_BACKBONES))
def test_lpips_backbone(net):
    """At 2 x 3 x 64 x 64: a seeded torchvision state dict (with and without the
    ``features.`` prefix) loaded as it is, and its flax variables (the JAX converter's)
    carried back by ``state_dict_from_flax``, each against the JAX backbone on them."""
    jmod, tmod, make_jax, make_port, dims = _BACKBONES[net]
    x = np.random.default_rng(9).uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    sd = _float32(seeded_state_dict(default_trunk(make_port, "cpu"), seed=10))
    variables = jmod.from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    want = jax.jit(make_jax().apply)(variables, jnp.asarray(x))
    model = default_trunk(make_port, "cpu")
    model.load_state_dict(sd)
    _assert_maps(_trunk_outputs(model, torch.from_numpy(x)), want, dims, "torchvision layout")
    carried = tmod.state_dict_from_flax(_numpy_tree(variables))
    assert carried.keys() == sd.keys()
    for k, v in carried.items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    _assert_maps(_trunk_outputs(load_trunk(default_trunk(make_port, "cpu"), carried), torch.from_numpy(x)), want, dims,
                 "carried from flax")
    bare = {k[len("features."):]: v for k, v in sd.items()}
    assert tmod.from_torch_state_dict(bare).keys() == sd.keys()
    builder = getattr(tmod, f"{ {'alex': 'alexnet', 'vgg': 'vgg16', 'squeeze': 'squeezenet'}[net]}_lpips_extractor")
    nhwc = _trunk_outputs(builder(state_dict=bare, device="cpu"), torch.from_numpy(x).permute(0, 2, 3, 1))
    _assert_maps(nhwc, want, dims, "bare keys, NHWC input")


def test_squeezenet_ceil_pools_on_odd_sizes():
    """``ceil_mode=True`` equals the JAX trunk's pool of a right / bottom ``-inf`` pad, at
    odd and even extents."""
    pool = torch.nn.MaxPool2d(3, 2, ceil_mode=True)
    for h, w in ((45, 51), (44, 50), (22, 25)):
        x = torch.randn(2, 5, h, w, generator=torch.Generator().manual_seed(h))
        padded = torch.nn.functional.pad(x, (0, (-(w - 3)) % 2, 0, (-(h - 3)) % 2), value=float("-inf"))
        torch.testing.assert_close(pool(x), torch.nn.functional.max_pool2d(padded, 3, 2), rtol=0, atol=0)


def test_vgg_scaling_layer():
    """``apply_scaling=True`` is the LPIPS scaling layer (the JAX trunk's shift and scale)
    applied first."""
    from torchmetrics_tpu_torch.functional.image.lpips import scaling_layer

    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(12)) * 2 - 1
    scaled, plain = default_trunk(tvgg.VGG16Features, "cpu"), default_trunk(lambda: tvgg.VGG16Features(False), "cpu")
    for a, b in zip(_trunk_outputs(scaled, x), _trunk_outputs(plain, scaling_layer(x))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tvgg._SHIFT == tuple(np.asarray(jvgg._SHIFT).tolist()) or np.allclose(tvgg._SHIFT, np.asarray(jvgg._SHIFT))


@pytest.mark.parametrize(("in_size", "out_size"), [(4, 8), (21, 299), (256, 299), (299, 299), (300, 299), (512, 299)])
def test_tf1_resize_matrix_is_the_jax_one(in_size, out_size):
    np.testing.assert_array_equal(tinc._tf1_resize_matrix(in_size, out_size).numpy(),
                                  np.asarray(jinc._tf1_resize_matrix(in_size, out_size)))


def test_tf1_bilinear_resize():
    """The port's NCHW resize against the JAX package's NHWC one; the matrices are cached."""
    x = np.random.default_rng(13).uniform(0, 255, (2, 3, 37, 23)).astype(np.float32)
    got = tinc.tf1_bilinear_resize(torch.from_numpy(x), (299, 61))
    want = np.asarray(jinc.tf1_bilinear_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (299, 61))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_ATOL)
    assert tinc._tf1_resize_matrix(37, 299) is tinc._tf1_resize_matrix(37, 299, "cpu")


def test_npz_round_trip(tmp_path):
    """A tree written by either package reads back equal in both; ``count_params`` agrees."""
    variables = _numpy_tree(jalex.AlexNetFeatures().init(jax.random.PRNGKey(7), jnp.zeros((1, 3, 64, 64), jnp.float32)))
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    n = tser.save_variables_npz(port_file, variables)
    assert n == jser.save_variables_npz(jax_file, variables) == tser.count_params(variables) == jser.count_params(variables)
    for path in (port_file, jax_file):
        for loaded in (tser.load_variables_npz(path), _numpy_tree(jser.load_variables_npz(path))):
            flat = jax.tree_util.tree_leaves_with_path(loaded)
            ref = dict(jax.tree_util.tree_leaves_with_path(variables))
            assert len(flat) == len(ref)
            for key, leaf in flat:
                assert isinstance(leaf, np.ndarray)
                np.testing.assert_array_equal(leaf, ref[key])
    model = load_trunk(default_trunk(talex.AlexNetFeatures, "cpu"), talex.state_dict_from_flax(tser.load_variables_npz(jax_file)))
    assert model.features[0].weight.shape == (64, 3, 11, 11)


def test_lpips_heads_copy_is_byte_equal():
    port = os.path.join(ROOT, "torchmetrics_tpu_torch", "functional", "image", "_weights", "lpips_heads.npz")
    ref = os.path.join(ROOT, "torchmetrics_tpu", "functional", "image", "_weights", "lpips_heads.npz")
    assert filecmp.cmp(port, ref, shallow=False)
    with np.load(port) as data:
        assert len(data.files) == 17


def test_default_init_is_seeded_and_leaves_the_global_generator():
    """Two default trunks hold the same weights; building them draws nothing from the
    global generator; BN statistics are the identity."""
    state = torch.random.get_rng_state()
    a, b = default_trunk(tsq.SqueezeNetFeatures, "cpu"), default_trunk(tsq.SqueezeNetFeatures, "cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert not any(p.requires_grad for p in a.parameters()) and not a.training
    bn = default_trunk(tinc.FIDInceptionV3, "cpu").Mixed_5b.branch1x1.bn
    assert torch.equal(bn.running_var, torch.ones(64)) and torch.equal(bn.running_mean, torch.zeros(64))


def test_trunk_runs_at_full_float32_and_restores_the_flags(fid_case):
    """Inside the extractor's forward TF32 is off; the caller's flags come back after."""
    sd = fid_case[0]
    extractor = tinc.fid_inception_v3_extractor("64", state_dict=sd, device="cpu")
    seen = []
    hook = extractor.model.Conv2d_1a_3x3.conv.register_forward_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    )
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        extractor(torch.zeros(1, 3, 8, 8, dtype=torch.uint8))
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
