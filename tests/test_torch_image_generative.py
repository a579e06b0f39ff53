"""FID, KID, the inception score and LPIPS: the port (on the CPU) against the JAX package.

The metric classes are held at the three protocol levels of
``tests/differential/harness.py`` with a small row-independent extractor given to both
packages: a fixed projection of the flattened uint8 image by a seeded numpy matrix of
integers / 4096, so every feature is a multiple of 2^-12 below 2^5 and comes out
exactly in float32 whatever the summation order. The trunks themselves are held in
``test_torch_image_models.py``. FID and KID cannot give a value for one batch (one side
per update; fewer samples than a subset), so their per-batch level is the same error in
both packages; the inception score and LPIPS compare ``forward`` values. LPIPS runs a
carried AlexNet (the JAX package's flax variables through ``state_dict_from_flax``) and
the bundled heads.

Tolerances: the states are exact (bit-equal features, float64 sums of them exact in any
order); FID relative 1e-9 (float64 eigendecompositions by two LAPACK builds); KID
relative 1e-5 (float32 kernel matrices summed in other orders); IS relative 1e-6;
LPIPS absolute 1e-6 (float32 convolutions; the JAX side runs its heads in float64 under
x64). The KID and IS subsets come from numpy's global generator in both packages, seeded
before each ``compute``.
"""

from __future__ import annotations

import doctest
import importlib
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.image as ji
import torchmetrics_tpu_torch.image as ti
from tests.torch_parity import assert_close, engine_split, np_
from torchmetrics_tpu.functional.image import lpips as jlp
from torchmetrics_tpu.models import alexnet as jalex
from torchmetrics_tpu_torch.engine import engine_context
from torchmetrics_tpu_torch.functional.image import lpips as tlp
from torchmetrics_tpu_torch.models import alexnet as talex
from torchmetrics_tpu_torch.models import inception as tinc

D_IN, D = 3 * 8 * 8, 16
_PROJ = np.random.default_rng(0).integers(-2, 3, (D_IN, D)).astype(np.float32) / 4096
_PROJ_T = torch.from_numpy(_PROJ)
_PROJ_J = jnp.asarray(_PROJ)
FID_RTOL, KID_RTOL, IS_RTOL, LPIPS_ATOL = 1e-9, 1e-5, 1e-6, 1e-6


def port_ext(x):
    return x.to(torch.float32).reshape(x.shape[0], -1) @ _PROJ_T


def jax_ext(x):
    return x.astype(jnp.float32).reshape(x.shape[0], -1) @ _PROJ_J


def _images(seed: int, sizes=(6, 5, 6, 7), lo: int = 0, hi: int = 256) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, (n, 3, 8, 8)).astype(np.uint8) for n in sizes]


def _side_batches(seed: int) -> list:
    """``(images, real)``: real and fake alternate; the fake images are brighter."""
    real, fake = _images(seed, hi=200), _images(seed + 1, lo=60)
    return [b for pair in zip(((r, True) for r in real), ((f, False) for f in fake)) for b in pair]


def _port_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a for a in args]


def _jax_args(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]


def _state_value(v):
    if isinstance(v, list):
        return np.concatenate([np_(x) for x in v]) if v else np.zeros(0)
    return np_(v)


def _assert_states(port, ref, atol: float = 0.0) -> None:
    """Every state equal in value (the JAX side's dtypes are its x64 ones); float states
    within ``atol`` when it is not 0."""
    for attr in ref._defaults:
        p, r = _state_value(getattr(port, attr)), _state_value(getattr(ref, attr))
        assert p.shape == r.shape, (attr, p.shape, r.shape)
        if atol and p.dtype.kind == "f":
            np.testing.assert_allclose(p, r, atol=atol, rtol=0, err_msg=attr)
        else:
            np.testing.assert_array_equal(p, r.astype(p.dtype), err_msg=attr)


def _computes(port, ref, seed: int):
    np.random.seed(seed)
    p = port.compute()
    np.random.seed(seed)
    return p, ref.compute()


def _forward(metric, args, seed: int):
    np.random.seed(seed)  # a batch value of KID / IS draws its subsets too
    return metric(*args)


def _levels(
    make_port, make_ref, batches, rtol: float, atol: float = 0.0, batch_value: bool = True, seed: int = 7,
    state_atol: float = 0.0,
):
    """The three levels: each batch's ``forward`` value (or, where a batch cannot give
    one, the same error in both), one instance's epoch ``compute``, the fold of two
    replicas; states equal throughout (float states within ``state_atol``)."""
    port, ref = make_port(), make_ref()
    for i, args in enumerate(batches):
        if batch_value:
            got = _forward(port, _port_args(args), seed + i)
            assert_close(got, _forward(ref, _jax_args(args), seed + i), atol, rtol, f"forward {i}")
        else:
            with pytest.raises((RuntimeError, ValueError)) as perr:
                make_port()(*_port_args(args))
            with pytest.raises(type(perr.value), match=str(perr.value).split(" ")[0]):
                make_ref()(*_jax_args(args))
            port.update(*_port_args(args))
            ref.update(*_jax_args(args))
    _assert_states(port, ref, state_atol)
    epoch = _computes(port, ref, seed)
    assert_close(*epoch, atol, rtol, "compute")

    pa, pb, ra, rb = make_port(), make_port(), make_ref(), make_ref()
    for i, args in enumerate(batches):
        first = i < len(batches) // 2
        (pa if first else pb).update(*_port_args(args))
        (ra if first else rb).update(*_jax_args(args))
    pa.merge_state(pb)
    ra.merge_state(rb)
    _assert_states(pa, ra, state_atol)
    merged = _computes(pa, ra, seed)
    assert_close(*merged, atol, rtol, "merged compute")
    assert_close(merged[0], epoch[1], atol, rtol, "merged against one instance")


# ---------------------------------------------------------------- FID


@pytest.mark.parametrize("normalize", [False, True])
def test_fid_three_levels(normalize):
    batches = _side_batches(0)
    if normalize:  # float images in [0, 1]; both packages scale by 255 and truncate to uint8
        batches = [((x / 255.0).astype(np.float32), r) for x, r in batches]
    _levels(
        lambda: ti.FrechetInceptionDistance(port_ext, num_features=D, normalize=normalize, device="cpu"),
        lambda: ji.FrechetInceptionDistance(jax_ext, num_features=D, normalize=normalize),
        batches, FID_RTOL, batch_value=False,
    )


def test_fid_tensor_flag_and_probe():
    """A 0-d tensor flag gives the same states as a Python bool; the callable's width is
    probed when ``num_features`` is not given; ``compute`` returns the extractor's dtype."""
    a = ti.FrechetInceptionDistance(lambda x: port_ext(x[:, :, :8, :8]), device="cpu")  # probed at 299 x 299
    b = ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu")
    assert a.num_features == D
    for x, real in _side_batches(1):
        a.update(torch.from_numpy(x), real)
        b.update(torch.from_numpy(x), torch.tensor(real))
    _assert_states(a, b)
    assert a.compute().dtype == torch.float32 and a.orig_dtype == torch.float32


def test_fid_reset_real_features():
    for keep in (True, False):
        port = ti.FrechetInceptionDistance(port_ext, num_features=D, reset_real_features=not keep, device="cpu")
        ref = ji.FrechetInceptionDistance(jax_ext, num_features=D, reset_real_features=not keep)
        for x, real in _side_batches(2):
            port.update(torch.from_numpy(x), real)
            ref.update(jnp.asarray(x), real)
        port.reset()
        ref.reset()
        _assert_states(port, ref)
        assert int(port.real_features_num_samples) == (24 if keep else 0)
        for x, real in _side_batches(3)[1::2]:
            port.update(torch.from_numpy(x), real)
            ref.update(jnp.asarray(x), real)
        if keep:
            assert_close(port.compute(), ref.compute(), 0.0, FID_RTOL, "kept real features")


def test_fid_guards():
    """Fewer than two samples on a side raises in both; the random trunk without the
    opt-in raises the JAX package's error; ``reset_real_features`` / ``normalize`` are
    type-checked."""
    port = ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu")
    ref = ji.FrechetInceptionDistance(jax_ext, num_features=D)
    x = _images(4, sizes=(3,))[0]
    port.update(torch.from_numpy(x), True)
    ref.update(jnp.asarray(x), True)
    port.update(torch.from_numpy(x[:1]), False)
    ref.update(jnp.asarray(x[:1]), False)
    msg = "More than one sample is required"
    with pytest.raises(RuntimeError, match=msg):
        port.compute()
    with pytest.raises(RuntimeError, match=msg):
        ref.compute()
    with pytest.raises(RuntimeError) as perr:
        ti.FrechetInceptionDistance(2048, device="cpu")
    with pytest.raises(RuntimeError) as jerr:
        ji.FrechetInceptionDistance(2048)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="must be one of"):
        ti.FrechetInceptionDistance(100, device="cpu")
    for kwargs in ({"reset_real_features": 1}, {"normalize": "yes"}):
        with pytest.raises(ValueError, match="expected to be a bool"):
            ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu", **kwargs)
    with pytest.raises(TypeError, match="unknown input"):
        ti.FrechetInceptionDistance(object(), device="cpu")


def test_random_trunk_warns_as_the_jax_package(monkeypatch):
    """With the opt-in, the port warns the JAX package's text and hands FID, KID and IS
    one shared trunk per (taps, device)."""
    import torchmetrics_tpu.models.inception as jinc

    monkeypatch.setattr(jinc, "_default_fid_extractor", lambda taps: None)  # no flax init here
    with pytest.warns(UserWarning) as jrec:
        jinc.fid_inception_v3_extractor("2048", allow_random=True)
    with pytest.warns(UserWarning) as prec:
        fid = ti.FrechetInceptionDistance(allow_random_features=True, device="cpu")
    jtext = [str(w.message) for w in jrec]
    assert jtext and set(jtext) <= {str(w.message) for w in prec}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kid = ti.KernelInceptionDistance(allow_random_features=True, device="cpu")
        inc = ti.InceptionScore(allow_random_features=True, device="cpu")
    assert fid.inception is kid.inception is tinc._default_fid_extractor(("2048",), "cpu")
    assert inc.inception is tinc._default_fid_extractor(("logits_unbiased",), "cpu")
    assert inc.inception.model is not fid.inception.model


# ---------------------------------------------------------------- KID


def test_kid_three_levels():
    _levels(
        lambda: ti.KernelInceptionDistance(port_ext, num_features=D, subsets=4, subset_size=10, device="cpu"),
        lambda: ji.KernelInceptionDistance(jax_ext, num_features=D, subsets=4, subset_size=10),
        _side_batches(6), KID_RTOL, atol=1e-12, batch_value=False,
    )


def test_kid_options_and_guards():
    kwargs = {"subsets": 3, "subset_size": 8, "degree": 2, "gamma": 0.5, "coef": 2.0, "reset_real_features": False}
    port = ti.KernelInceptionDistance(port_ext, num_features=D, **kwargs, device="cpu")
    ref = ji.KernelInceptionDistance(jax_ext, num_features=D, **kwargs)
    for x, real in _side_batches(7):
        port.update(torch.from_numpy(x), real)
        ref.update(jnp.asarray(x), real)
    assert_close(*_computes(port, ref, 3), 1e-12, KID_RTOL, "kid options")
    port.reset()
    ref.reset()
    _assert_states(port, ref)
    assert len(port.real_features) == 4 and not port.fake_features
    big = ti.KernelInceptionDistance(port_ext, num_features=D, subset_size=25, device="cpu")
    for x, real in _side_batches(7):
        big.update(torch.from_numpy(x), real)
    with pytest.raises(ValueError, match="`subset_size` should be smaller"):
        big.compute()
    for bad, match in (({"subsets": 0}, "subsets"), ({"subset_size": 1.5}, "subset_size"), ({"degree": 0}, "degree"),
                       ({"gamma": 1}, "gamma"), ({"coef": -1.0}, "coef")):
        with pytest.raises(ValueError, match=match):
            ti.KernelInceptionDistance(port_ext, num_features=D, device="cpu", **bad)


def test_poly_mmd_batched_against_jax():
    """The batched MMD of a (subsets, m, d) stack equals the JAX package's per-subset MMDs."""
    from torchmetrics_tpu.image.kid import poly_mmd as jpoly
    from torchmetrics_tpu_torch.image.kid import poly_mmd as tpoly

    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((3, 12, 5)).astype(np.float32), rng.standard_normal((3, 12, 5)).astype(np.float32)
    got = tpoly(torch.from_numpy(a), torch.from_numpy(b))
    want = [float(jpoly(jnp.asarray(a[i]), jnp.asarray(b[i]))) for i in range(3)]
    assert_close(got, np.asarray(want, dtype=np.float32), 1e-6, KID_RTOL, "poly_mmd")


# ---------------------------------------------------------------- IS


def test_inception_score_three_levels():
    batches = [(x,) for x in _images(9, sizes=(6, 6, 6, 6))]  # one shape: the JAX side compiles once
    _levels(
        lambda: ti.InceptionScore(port_ext, num_features=D, splits=3, device="cpu"),
        lambda: ji.InceptionScore(jax_ext, num_features=D, splits=3),
        batches, IS_RTOL, atol=1e-6,
    )


def test_inception_score_normalize_and_guards():
    x = (_images(10, sizes=(9,))[0] / 255.0).astype(np.float32)
    port = ti.InceptionScore(port_ext, num_features=D, splits=2, normalize=True, device="cpu")
    ref = ji.InceptionScore(jax_ext, num_features=D, splits=2, normalize=True)
    port.update(torch.from_numpy(x))
    ref.update(jnp.asarray(x))
    _assert_states(port, ref)
    assert_close(*_computes(port, ref, 1), 1e-6, IS_RTOL, "normalize")
    with pytest.raises(ValueError, match="splits"):
        ti.InceptionScore(port_ext, num_features=D, splits=0, device="cpu")


# ---------------------------------------------------------------- LPIPS


@pytest.fixture(scope="module")
def alex_nets():
    """The JAX AlexNet's flax variables carried into the port; both nets with the bundled heads."""
    variables = jalex.AlexNetFeatures().init(jax.random.PRNGKey(3), jnp.zeros((1, 3, 64, 64), jnp.float32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return _alex_pair(variables, spatial=False), variables


def _alex_pair(variables, spatial: bool) -> tuple:
    port = talex.alexnet_lpips_extractor(variables=variables, device="cpu")
    ref = jalex.alexnet_lpips_extractor(variables=variables)
    return (tlp.make_lpips_net(port, tlp.load_lpips_heads("alex"), spatial=spatial),
            jlp.make_lpips_net(ref, jlp.load_lpips_heads("alex"), spatial=spatial))


def _pairs(seed: int, n: int = 3, lo: float = -1.0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):  # one shape: the JAX pipeline's eager operations compile once
        a = rng.uniform(lo, 1, (2, 3, 64, 64)).astype(np.float32)
        out.append((a, np.clip(0.7 * a + 0.3 * rng.uniform(lo, 1, a.shape), lo, 1).astype(np.float32)))
    return out


@pytest.mark.parametrize("kwargs", [{}, {"reduction": "sum", "normalize": True}], ids=["mean", "sum-normalize"])
def test_lpips_three_levels(alex_nets, kwargs):
    port_net, ref_net = alex_nets[0]
    _levels(
        lambda: ti.LearnedPerceptualImagePatchSimilarity(port_net, **kwargs, device="cpu"),
        lambda: ji.LearnedPerceptualImagePatchSimilarity(ref_net, **kwargs),
        _pairs(11, lo=0.0 if kwargs.get("normalize") else -1.0), 0.0, atol=LPIPS_ATOL, state_atol=LPIPS_ATOL,
    )


def test_lpips_functional_spatial_and_range_error(alex_nets):
    port_net, ref_net = alex_nets[0]
    (a, b), = _pairs(12, n=1)
    for reduction in ("mean", "sum"):
        assert_close(
            tlp.learned_perceptual_image_patch_similarity(torch.from_numpy(a), torch.from_numpy(b), port_net, reduction),
            jlp.learned_perceptual_image_patch_similarity(jnp.asarray(a), jnp.asarray(b), ref_net, reduction),
            LPIPS_ATOL, 0.0, reduction,
        )
    port_sp, ref_sp = _alex_pair(alex_nets[1], spatial=True)
    assert_close(port_sp(torch.from_numpy(a), torch.from_numpy(b)), ref_sp(jnp.asarray(a), jnp.asarray(b)),
                 LPIPS_ATOL, 0.0, "spatial map")
    bad = a * 3
    with pytest.raises(ValueError, match="Expected both input arguments to be normalized tensors") as perr:
        tlp.learned_perceptual_image_patch_similarity(torch.from_numpy(bad), torch.from_numpy(b), port_net)
    with pytest.raises(ValueError) as jerr:
        jlp.learned_perceptual_image_patch_similarity(jnp.asarray(bad), jnp.asarray(b), ref_net)
    assert str(perr.value).split(" and values")[0] == str(jerr.value).split(" and values")[0]
    with pytest.raises(ValueError, match="normalized tensors"):
        tlp.learned_perceptual_image_patch_similarity(torch.from_numpy(a), torch.from_numpy(b), port_net, normalize=True)
    with pytest.raises(ValueError, match="must be a backbone name"):
        tlp.learned_perceptual_image_patch_similarity(torch.from_numpy(a), torch.from_numpy(b), 3)


def test_lpips_is_differentiable(alex_nets):
    """The gradient through ``img1`` flows (no ``no_grad`` in the pipeline) and equals the
    JAX package's ``jax.grad`` of the same distance."""
    port_net, ref_net = alex_nets[0]
    (a, b), = _pairs(13, n=1)
    x = torch.from_numpy(a).requires_grad_(True)
    m = ti.LearnedPerceptualImagePatchSimilarity(port_net, device="cpu")
    m(x, torch.from_numpy(b)).backward()
    # the mean distance of the pairs, as the metric's batch value (jitted: its range check is host Python)
    jgrad = jax.jit(jax.grad(lambda u: ref_net(u, jnp.asarray(b)).mean()))(jnp.asarray(a))
    assert_close(x.grad, jgrad, 1e-7, 1e-3, "gradient")
    assert m.is_differentiable and not any(p.requires_grad for p in port_net.feats_fn.parameters())


def test_lpips_string_nets_and_guards():
    with pytest.raises(RuntimeError) as perr:
        ti.LearnedPerceptualImagePatchSimilarity("vgg", device="cpu")
    with pytest.raises(RuntimeError) as jerr:
        ji.LearnedPerceptualImagePatchSimilarity("vgg")
    assert str(perr.value) == str(jerr.value)
    with pytest.warns(UserWarning, match="randomly-initialised `squeeze` backbone"):
        m = ti.LearnedPerceptualImagePatchSimilarity("squeeze", allow_random_backbone=True, device="cpu")
    assert m.net is tlp._default_lpips_network("squeeze", False, "cpu")
    for bad, match in (({"net_type": "resnet"}, "net_type"), ({"net_type": 3}, "string or a callable"),
                       ({"reduction": "max"}, "reduction"), ({"normalize": 1}, "bool")):
        with pytest.raises(ValueError, match=match):
            ti.LearnedPerceptualImagePatchSimilarity(**{"net_type": lambda *a, **k: None, **bad}, device="cpu")
    with pytest.raises(ValueError, match="net_type"):
        tlp.load_lpips_heads("resnet")


# ---------------------------------------------------------------- engine, device moves, checkpoints


def test_engine_split():
    """FID with a tensor flag replays (the bucketed pad rows are zero images, whose
    projected features are zero); a Python bool falls back on every update, the JAX
    engine's ``non-array-input``; KID and IS fall back on their lists; LPIPS's range check
    reads the host, the JAX engine's trace failure, then its cached refusal."""
    from torchmetrics_tpu.engine import engine_context as jax_engine_context

    flag = [(x, np.asarray(r)) for x, r in _side_batches(14)]
    with jax.enable_x64(False), jax_engine_context(True, donate=True):
        ref = ji.FrechetInceptionDistance(jax_ext, num_features=D)
        for x, r in flag:
            ref.update(jnp.asarray(x), jnp.asarray(r))
    runs = {}
    for on in (True, False):
        with engine_context(on):
            runs[on] = ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu")
            for x, r in flag:
                runs[on].update(torch.from_numpy(x), torch.from_numpy(r))
    _assert_states(runs[True], runs[False])
    pst, jst = runs[True]._engine.stats, ref._engine.stats
    assert (pst.dispatches, pst.eager_fallbacks, jst.eager_fallbacks) == (jst.dispatches, 0, 0) == (len(flag), 0, 0)
    assert pst.bucketed_steps == len(flag)
    with engine_context(True):
        m = ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu")
        for x, real in _side_batches(14):
            m.update(torch.from_numpy(x), real)
        assert dict(m._engine.stats.fallback_reasons) == {"non-tensor-input": 8}
        assert m.compute().dtype == torch.float32
        assert m._epoch is None  # the compute runs eagerly: no graph holds CUDA's eigh
    sides = [(b, b) for b in _side_batches(15)]
    engine_split(
        lambda: _seeded(ti.KernelInceptionDistance)(port_ext, num_features=D, subset_size=4, device="cpu"),
        lambda: ji.KernelInceptionDistance(jax_ext, num_features=D, subset_size=4),
        [((x, r), (x, r)) for (x, r), _ in sides],
    )
    engine_split(
        lambda: _seeded(ti.InceptionScore)(port_ext, num_features=D, device="cpu"),
        lambda: ji.InceptionScore(jax_ext, num_features=D), [((x,), (x,)) for x in _images(16)],
    )


def _seeded(cls):
    """``cls`` whose ``compute`` draws its subsets from numpy's generator seeded 0."""

    class Seeded(cls):
        def compute(self):
            np.random.seed(0)
            return super().compute()

    return Seeded


def test_engine_split_lpips(alex_nets):
    port_net, ref_net = alex_nets[0]
    engine_split(
        lambda: ti.LearnedPerceptualImagePatchSimilarity(port_net, device="cpu"),
        lambda: ji.LearnedPerceptualImagePatchSimilarity(ref_net), [(p, p) for p in _pairs(17)],
        port_refusal="host-read:_local_scalar_dense",
    )


def test_engine_pad_rows_of_the_trunk():
    """A ragged update through the seeded trunk (real features of zero pad images) lands
    within float64 rounding of the eager update; full batches are bit-equal."""
    x = torch.from_numpy(_images(18, sizes=(8, 5))[0])
    y = torch.from_numpy(_images(19, sizes=(5,))[0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eager = ti.FrechetInceptionDistance(64, allow_random_features=True, device="cpu")
        with engine_context(True):
            graph = ti.FrechetInceptionDistance(64, allow_random_features=True, device="cpu")
    for m in (eager, graph):
        with engine_context(m is graph):
            m.update(x, torch.tensor(True))
    _assert_states(graph, eager)
    for m in (eager, graph):
        with engine_context(m is graph):
            m.update(y, torch.tensor(False))
    assert graph._engine.stats.bucket_pad_rows == 3
    for attr in graph._defaults:
        assert_close(getattr(graph, attr), getattr(eager, attr), 1e-12, 1e-9, attr)


def test_engine_full_batches_take_exact_shape_graphs():
    """With a tensor flag, a batch that fills its bucket takes an exact-shape graph, whose
    replay runs the extractor once; a ragged batch rides its bucket, whose step also runs
    the extractor on the pad row (a unit fed by the 0-d flag is not constant)."""
    seen = []

    def counting_ext(x):
        seen.append(x.shape[0])
        return port_ext(x)

    sizes = (8, 8, 5, 16, 5)
    batches = _images(21, sizes=sizes)
    with engine_context(True):
        graph = ti.FrechetInceptionDistance(counting_ext, num_features=D, device="cpu")
        for i, x in enumerate(batches):
            seen.clear()
            graph.update(torch.from_numpy(x), torch.tensor(i % 2 == 0))
            assert seen == ([x.shape[0]] if x.shape[0] in (8, 16) else [8, 1]), (i, seen)
    eager = ti.FrechetInceptionDistance(port_ext, num_features=D, device="cpu")
    for i, x in enumerate(batches):
        eager.update(torch.from_numpy(x), torch.tensor(i % 2 == 0))
    st = graph._engine.stats
    assert (st.dispatches, st.eager_fallbacks, st.bucketed_steps, st.bucket_pad_rows) == (5, 0, 2, 6)
    _assert_states(graph, eager)


class _Movable:
    """An extractor that records its moves and hands back a new object."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def __call__(self, x):
        return port_ext(x)

    def to(self, device):
        return _Movable(device)


def test_to_moves_the_extractor():
    """``to`` swaps a default trunk for the new device's cached one (not a move in place),
    hands any extractor with ``to`` the device, and moves LPIPS's net the same way."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fid = ti.FrechetInceptionDistance(64, allow_random_features=True, device="cpu")
    cpu_trunk = fid.inception
    fid.to("meta")
    assert fid.inception is tinc._default_fid_extractor(("64",), "meta") and fid.inception.device.type == "meta"
    assert fid.real_features_sum.device.type == "meta"
    assert cpu_trunk is tinc._default_fid_extractor(("64",), "cpu") and cpu_trunk.device.type == "cpu"
    for cls in (ti.FrechetInceptionDistance, ti.KernelInceptionDistance, ti.InceptionScore):
        m = cls(_Movable(), num_features=D, device="cpu")
        held = m.inception
        m.to("cpu")
        assert m.inception is not held and isinstance(m.inception, _Movable)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lp = ti.LearnedPerceptualImagePatchSimilarity("alex", allow_random_backbone=True, device="cpu")
    lp.to("meta")
    assert lp.net is tlp._default_lpips_network("alex", False, "meta")
    assert lp.net.lin_weights[0].device.type == "meta"


def test_a_moved_clone_leaves_the_original_trunk(alex_nets):
    """A clone shares the trunk of the metric it was cloned from; moving the clone moves a
    copy of a trunk with weights, so the original's trunk stays where its states are and
    its next update runs."""
    port_net = alex_nets[0][0]
    fid = ti.FrechetInceptionDistance(tinc.fid_inception_v3_extractor("64", state_dict=_fidelity_sd(), device="cpu"),
                                      num_features=64, device="cpu")
    lp = ti.LearnedPerceptualImagePatchSimilarity(port_net, device="cpu")
    for m, attr in ((fid, "inception"), (lp, "net")):
        held = getattr(m, attr)
        clone = m.clone()
        assert getattr(clone, attr) is held
        clone.to("meta")
        copy = getattr(clone, attr)
        assert copy is not held and copy.device.type == "meta" and held.device.type == "cpu"
        assert all(p.device.type == "cpu" for p in (held.model if attr == "inception" else held.feats_fn).parameters())
    fid.update(torch.from_numpy(_images(22, sizes=(2,))[0]), torch.tensor(True))
    assert int(fid.real_features_num_samples) == 2
    a, b = _pairs(23, n=1)[0]
    lp.update(torch.from_numpy(a), torch.from_numpy(b))
    assert float(lp.total) == 2.0


def test_state_dict_holds_no_trunk_parameters():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fid = ti.FrechetInceptionDistance(64, allow_random_features=True, device="cpu")
        lp = ti.LearnedPerceptualImagePatchSimilarity("alex", allow_random_backbone=True, device="cpu")
    assert fid.state_dict() == {} and lp.state_dict() == {}
    fid.persistent(True)
    assert set(fid.state_dict()) == set(fid._defaults) | {"_update_count"}
    assert not list(fid.parameters()) and not list(lp.parameters())
    clone = fid.clone()
    assert clone.inception is fid.inception
    for metric, attr in ((fid, "inception"), (lp, "net")):  # a pickle rebuilds a default trunk from the cache
        assert getattr(pickle.loads(pickle.dumps(metric)), attr) is getattr(metric, attr)
    custom = ti.FrechetInceptionDistance(tinc.fid_inception_v3_extractor("64", state_dict=_fidelity_sd(), device="cpu"),
                                         num_features=64, device="cpu")
    copy = pickle.loads(pickle.dumps(custom))
    x = torch.from_numpy(_images(20, sizes=(2,))[0])
    torch.testing.assert_close(copy.inception(x), custom.inception(x), rtol=0, atol=0)


def _fidelity_sd() -> dict:
    """A seeded torch-fidelity-layout state dict (the port's seeded trunk's, re-drawn)."""
    from tests.image.torch_mirrors import seeded_state_dict
    from torchmetrics_tpu_torch.models._common import default_trunk

    return seeded_state_dict(default_trunk(tinc.FIDInceptionV3, "cpu"), seed=21)


@pytest.mark.parametrize("module", ["fid", "kid", "inception", "lpip"])
def test_docstring_examples(module):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        results = doctest.testmod(importlib.import_module(f"torchmetrics_tpu_torch.image.{module}"),
                                  optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
