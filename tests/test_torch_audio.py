"""The audio domain: the port (on the CPU) against the JAX package.

The same seeded numpy signals go through the JAX functions (64-bit mode, as
``tests/conftest.py`` sets it) and the port's: SNR (``zero_mean`` both ways), SI-SNR,
SI-SDR and C-SI-SNR (complex input, and real input with a trailing 2) at relative
``RTOL``; SDR at ``filter_length`` 512 and 64, with ``zero_mean`` and ``load_diag``,
bit-equal after the float32 cast (the port solves in float64 as the JAX package does
in 64-bit mode) and within ``SDR64_RTOL`` for float64 inputs; an all-zero target gives
NaN, and ``-inf`` with ``load_diag``, in both. PIT chooses the same permutations as the
JAX package at S = 2 to 5, max and min, speaker-wise and permutation-wise, a row of NaN
included (permutation 0), and ``pit_permutate`` reorders alike. The five modular
classes run at the three protocol levels of ``tests/differential/harness.py``; the JAX
side's sum state is float64 in 64-bit mode, the port's float32 (held to ``RTOL``). The
PESQ / STOI wrappers keep the backend contract of
``tests/audio/test_pesq_stoi_contract.py`` against the same fake backends, and raise
the same ``ModuleNotFoundError`` without them. A JAX ``SignalNoiseRatio`` state carries
into the port through ``interop.state_from_jax``, and the engine's replay / fallback
split of ``chip_smoke.py``'s phase 22 paths is pinned with the constants the script
asserts.
"""

from __future__ import annotations

import doctest
import importlib
import itertools
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import torchmetrics_tpu as jtm
import torchmetrics_tpu.audio as ja
import torchmetrics_tpu.functional.audio as jF
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.audio as ta
import torchmetrics_tpu_torch.functional.audio as tF
from tests.torch_parity import assert_close, engine_split, three_levels_args
from torchmetrics_tpu_torch.interop import state_from_jax

RTOL = 1e-5  # float32 sums over a signal, added in another order
SDR64_RTOL = 1e-12  # float64 end to end: the FFTs and the solve round differently


def _signals(seed: int, shape: tuple, noise: float = 0.3, dtype=np.float32) -> tuple:
    """``(preds, target)``: a seeded target and a noised copy."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape)
    preds = target + noise * rng.standard_normal(shape)
    return preds.astype(dtype), target.astype(dtype)


def _both(fn: str, *arrays, **kwargs):
    return (
        getattr(tF, fn)(*[torch.from_numpy(a) for a in arrays], **kwargs),
        getattr(jF, fn)(*[jnp.asarray(a) for a in arrays], **kwargs),
    )


@pytest.mark.parametrize(
    "fn, kwargs",
    [("signal_noise_ratio", {}), ("signal_noise_ratio", {"zero_mean": True}), ("scale_invariant_signal_noise_ratio", {}),
     ("scale_invariant_signal_distortion_ratio", {}), ("scale_invariant_signal_distortion_ratio", {"zero_mean": True})],
    ids=str,
)
def test_snr_family_functional(fn, kwargs):
    port, ref = _both(fn, *_signals(0, (3, 2, 1000)), **kwargs)
    assert port.dtype == torch.float32 and port.shape == (3, 2)
    assert_close(port, ref, 0.0, RTOL, fn)


def test_complex_si_snr_functional():
    rng = np.random.default_rng(1)
    spec = lambda: rng.standard_normal((2, 9, 7)) + 1j * rng.standard_normal((2, 9, 7))  # noqa: E731
    target = spec().astype(np.complex64)
    preds = (target + 0.2 * spec()).astype(np.complex64)
    for kwargs in ({}, {"zero_mean": True}):
        port, ref = _both("complex_scale_invariant_signal_noise_ratio", preds, target, **kwargs)
        assert_close(port, ref, 0.0, RTOL, f"complex {kwargs}")
        real = [np.stack([x.real, x.imag], -1) for x in (preds, target)]
        port_real, ref_real = _both("complex_scale_invariant_signal_noise_ratio", *real, **kwargs)
        assert_close(port_real, ref_real, 0.0, RTOL, f"real {kwargs}")
        assert torch.equal(port, port_real)


@pytest.mark.parametrize("filter_length, n", [(512, 4000), (512, 600), (64, 500)])
@pytest.mark.parametrize("kwargs", [{}, {"zero_mean": True}, {"load_diag": 1e-3}], ids=str)
def test_sdr_functional(filter_length, n, kwargs):
    """Bit-equal after the float32 cast; float64 inputs give float64 within ``SDR64_RTOL``."""
    preds, target = _signals(2, (3, n))
    port, ref = _both("signal_distortion_ratio", preds, target, filter_length=filter_length, **kwargs)
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    port, ref = _both("signal_distortion_ratio", preds.astype(np.float64), target.astype(np.float64),
                      filter_length=filter_length, **kwargs)
    assert port.dtype == torch.float64
    assert_close(port, ref, 0.0, SDR64_RTOL, "float64")


def test_sdr_zero_target_and_ignored_cg_iter():
    preds, _ = _signals(3, (2, 600))
    zero = np.zeros_like(preds)
    port, ref = _both("signal_distortion_ratio", preds, zero, filter_length=64)
    assert torch.isnan(port).all() and np.isnan(np.asarray(ref)).all()
    port, ref = _both("signal_distortion_ratio", preds, zero, filter_length=64, load_diag=1e-5)
    assert torch.isneginf(port).all() and np.isneginf(np.asarray(ref)).all()
    preds, target = _signals(4, (2, 700))
    a, _ = _both("signal_distortion_ratio", preds, target, filter_length=64)
    b, _ = _both("signal_distortion_ratio", preds, target, filter_length=64, use_cg_iter=10)
    assert torch.equal(a, b)


def _pit_inputs(seed: int, batch: int, spk: int, n: int = 300) -> tuple:
    """Targets and predictions that are a per-sample shuffle of them plus noise."""
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((batch, spk, n)).astype(np.float32)
    order = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, order[:, :, None], 1) + 0.5 * rng.standard_normal((batch, spk, n))
    return preds.astype(np.float32), target


@pytest.mark.parametrize("spk", [2, 3, 4, 5])
@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_speaker_wise(spk, eval_func):
    preds, target = _pit_inputs(5 + spk, 4, spk, n=200)
    # one metric per direction: SI-SDR maximised, SNR minimised
    for metric in ("scale_invariant_signal_distortion_ratio",) if eval_func == "max" else ("signal_noise_ratio",):
        pv, pp = tF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target),
                                                   getattr(tF, metric), eval_func=eval_func)
        jv, jp = jF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), getattr(jF, metric),
                                                   eval_func=eval_func)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp), err_msg=metric)
        assert_close(pv, jv, 0.0, RTOL, metric)
        permuted = tF.pit_permutate(torch.from_numpy(preds), pp)
        np.testing.assert_array_equal(permuted.numpy(), np.asarray(jF.pit_permutate(jnp.asarray(preds), jp)))


@pytest.mark.parametrize("eval_func", ["max", "min"])
def test_pit_permutation_wise_and_kwargs(eval_func):
    preds, target = _pit_inputs(11, 3, 3, n=400)
    port = tF.permutation_invariant_training(
        torch.from_numpy(preds), torch.from_numpy(target), tF.signal_distortion_ratio, "permutation-wise", eval_func,
        filter_length=32,
    )
    ref = jF.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), jF.signal_distortion_ratio, "permutation-wise", eval_func,
        filter_length=32,
    )
    np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]))
    assert_close(port[0], ref[0], 0.0, RTOL)  # each SDR bit-equal; their float32 mean rounds alike or an ulp off


def test_pit_nan_rows_and_ties():
    """A row of NaN keeps permutation 0 (argmax / argmin of all-NaN is index 0); a NaN
    in one pair of a row wins that row in both packages; a tie goes to the first."""
    preds, target = _pit_inputs(12, 4, 3)
    preds[0] = np.nan
    preds[1, 1] = np.nan
    preds[2] = preds[2, :1]  # every speaker the same: every permutation ties
    target[2] = target[2, :1]
    for eval_func in ("max", "min"):
        for mode in ("speaker-wise", "permutation-wise"):
            port = tF.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target),
                                                     tF.signal_noise_ratio, mode, eval_func)
            ref = jF.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), jF.signal_noise_ratio,
                                                    mode, eval_func)
            np.testing.assert_array_equal(port[1].numpy(), np.asarray(ref[1]), err_msg=f"{mode} {eval_func}")
            assert port[1][0].tolist() == [0, 1, 2] and port[1][2].tolist() == [0, 1, 2]
            assert_close(port[0], ref[0], 0.0, RTOL, f"{mode} {eval_func}")


def test_permutation_table_order():
    from torchmetrics_tpu_torch.functional.audio.pit import _gen_permutations

    for spk in range(1, 7):
        perms, speakers = _gen_permutations(spk, torch.device("cpu"))
        assert perms.tolist() == [list(p) for p in itertools.permutations(range(spk))]
        assert speakers.tolist() == [list(range(spk))]
        assert _gen_permutations(spk, torch.device("cpu"))[0] is perms  # built once


def _raises_like_jax(port_call, jax_call) -> None:
    """The port raises what the JAX package raises, with the same message (shapes as
    ``torch.Size([...])`` read as tuples)."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(type(want.value)) as got:
        port_call()
    assert str(got.value).replace("torch.Size([", "(").replace("])", ")") == str(want.value)


def test_input_errors():
    x = np.zeros((2, 3, 16), np.float32)
    y = np.zeros((2, 3, 15), np.float32)
    t, j = torch.from_numpy, jnp.asarray
    calls = [
        ("signal_noise_ratio", (x, y), {}),
        ("scale_invariant_signal_distortion_ratio", (x, y), {}),
        ("signal_distortion_ratio", (x, y), {}),
        ("complex_scale_invariant_signal_noise_ratio", (x, x), {}),
        ("complex_scale_invariant_signal_noise_ratio", (x[0, :, :2], x[0, :, :2]), {}),
        ("permutation_invariant_training", (x, x[:, :2]), {"metric_func": None}),
        ("permutation_invariant_training", (x, x), {"metric_func": None, "eval_func": "mean"}),
        ("permutation_invariant_training", (x, x), {"metric_func": None, "mode": "pair-wise"}),
        ("permutation_invariant_training", (x[0, 0], x[0, 0]), {"metric_func": None}),
    ]
    for fn, arrays, kwargs in calls:
        _raises_like_jax(lambda: getattr(tF, fn)(*map(t, arrays), **kwargs),
                         lambda: getattr(jF, fn)(*map(j, arrays), **kwargs))
    _raises_like_jax(lambda: ta.ComplexScaleInvariantSignalNoiseRatio(zero_mean=1, device="cpu"),
                     lambda: ja.ComplexScaleInvariantSignalNoiseRatio(zero_mean=1))


def _batches(seed: int, shape: tuple, n: int = 3) -> list:
    return [_signals(seed + i, shape) for i in range(n)]


# (class, port kwargs, JAX kwargs, batches)
_SPEC = np.stack(_signals(20, (3, 2, 8, 6, 2)))
MODULAR = [
    ("SignalNoiseRatio", {}, {}, _batches(21, (4, 500))),
    ("SignalNoiseRatio", {"zero_mean": True}, {"zero_mean": True}, _batches(22, (2, 3, 400))),
    ("ScaleInvariantSignalNoiseRatio", {}, {}, _batches(23, (4, 500))),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, {"zero_mean": True}, _batches(24, (4, 500))),
    ("SignalDistortionRatio", {"filter_length": 64}, {"filter_length": 64}, _batches(25, (3, 600))),
    ("ComplexScaleInvariantSignalNoiseRatio", {}, {}, _batches(26, (2, 8, 6, 2))),
    ("PermutationInvariantTraining", {"metric_func": tF.scale_invariant_signal_distortion_ratio},
     {"metric_func": jF.scale_invariant_signal_distortion_ratio}, [_pit_inputs(27 + i, 3, 2) for i in range(3)]),
    ("PermutationInvariantTraining", {"metric_func": tF.signal_noise_ratio, "eval_func": "min", "zero_mean": True},
     {"metric_func": jF.signal_noise_ratio, "eval_func": "min", "zero_mean": True},
     [_pit_inputs(30 + i, 2, 4) for i in range(3)]),
]


@pytest.mark.parametrize("name, port_kwargs, jax_kwargs, batches", MODULAR,
                         ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULAR)])
def test_modular(name, port_kwargs, jax_kwargs, batches):
    three_levels_args(
        lambda: getattr(ta, name)(**port_kwargs, device="cpu"),
        lambda: getattr(ja, name)(**jax_kwargs),
        [(b, b) for b in batches],
        0.0, RTOL, float_state_rtol=RTOL,
    )


def test_pit_routes_metric_options_to_the_base():
    m = ta.PermutationInvariantTraining(tF.signal_noise_ratio, device="cpu", compute_with_cache=False, zero_mean=True)
    assert m.device.type == "cpu" and m.compute_with_cache is False and m.kwargs == {"zero_mean": True}


def test_sdr_metric_keeps_float32_state_for_float64_input():
    preds, target = _signals(40, (2, 600), dtype=np.float64)
    m = ta.SignalDistortionRatio(filter_length=64, device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert m.sum_value.dtype == torch.float32 and m.total.dtype == torch.int32
    ref = ja.SignalDistortionRatio(filter_length=64)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert_close(m.compute(), ref.compute(), 0.0, RTOL)


def test_state_carried_in_from_jax():
    """Two updates in the JAX package, its state through ``state_from_jax`` into the
    port, one more update on each side: equal computes."""
    batches = _batches(41, (4, 500))
    for make_port, make_ref in (
        (lambda: ta.SignalNoiseRatio(device="cpu"), ja.SignalNoiseRatio),
        (lambda: ta.PermutationInvariantTraining(tF.signal_noise_ratio, device="cpu"),
         lambda: ja.PermutationInvariantTraining(jF.signal_noise_ratio)),
    ):
        ref, port = make_ref(), make_port()
        ref.persistent(True)
        data = batches if "Permutation" not in type(port).__name__ else [_pit_inputs(42 + i, 2, 3) for i in range(3)]
        for preds, target in data[:2]:
            ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.load_state_dict(state_from_jax(ref.state_dict(), "cpu"))
        assert port.update_count == 2 and port.total.dtype == torch.int32
        preds, target = data[2]
        ref.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        assert_close(port.compute(), ref.compute(), 0.0, RTOL, type(port).__name__)


# ---------------------------------------------------------------- the engine split


def _path_metric(path: str, port: bool):
    """A phase 22 path's metric (one member for ``dns``) at a test width."""
    pkg, fn = (ta, tF) if port else (ja, jF)
    extra = {"device": "cpu"} if port else {}
    return {
        "dns": lambda: pkg.ScaleInvariantSignalDistortionRatio(**extra),
        "sdr": lambda: pkg.SignalDistortionRatio(filter_length=64, **extra),
        "pit2": lambda: pkg.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, **extra),
        "pit3": lambda: pkg.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, **extra),
        "pit4": lambda: pkg.PermutationInvariantTraining(fn.scale_invariant_signal_distortion_ratio, **extra),
        "pit_sdr": lambda: pkg.PermutationInvariantTraining(fn.signal_distortion_ratio, "permutation-wise",
                                                            filter_length=32, **extra),
        "csisnr": lambda: pkg.ComplexScaleInvariantSignalNoiseRatio(**extra),
    }[path]


def _path_batches(path: str) -> list:
    if path.startswith("pit"):
        spk = {"pit2": 2, "pit3": 3, "pit4": 4, "pit_sdr": 2}[path]
        return [_pit_inputs(50 + i, 2, spk, n=200) for i in range(3)]
    if path == "csisnr":
        rng = np.random.default_rng(53)
        out = []
        for _ in range(3):
            t = (rng.standard_normal((2, 5, 4)) + 1j * rng.standard_normal((2, 5, 4))).astype(np.complex64)
            out.append(((t + 0.3 * t.conj()).astype(np.complex64), t))
        return out
    return _batches(54, (2, 300))


@pytest.mark.parametrize("path", [p for p in chip_smoke.AUDIO_PATHS if p != "clip"])
def test_engine_split(path, monkeypatch):
    """Each phase 22 path under the engine on the CPU: the split ``chip_smoke.py``
    asserts on the card. The card's solve refusal (PyTorch's default backend, MAGMA in
    the build) is emulated by making the solve uncapturable here; the JAX engine
    replays SDR, so those paths are held to the pinned reason alone."""
    import torchmetrics_tpu_torch.functional.audio.sdr as sdr_mod
    from torchmetrics_tpu_torch.engine import engine_context

    monkeypatch.setattr(sdr_mod, "_solve_capturable", lambda device: False)
    batches = [(b, b) for b in _path_batches(path)]
    reason = chip_smoke.AUDIO_FALLBACK_REASONS.get(path)
    if path in chip_smoke.AUDIO_REPLAYING:
        st = engine_split(lambda: _path_metric(path, True)(), lambda: _path_metric(path, False)(), batches)
        assert st.dispatches == len(batches) and st.eager_fallbacks == 0
        return
    if path == "pit4":
        st = engine_split(lambda: _path_metric(path, True)(), lambda: _path_metric(path, False)(), batches,
                          port_refusal=reason)
    else:
        with engine_context(True):
            port = _path_metric(path, True)()
            for pargs, _ in batches:
                port.update(*[torch.from_numpy(a) for a in pargs])
        eager = _path_metric(path, True)()
        for pargs, _ in batches:
            eager.update(*[torch.from_numpy(a) for a in pargs])
        assert torch.equal(port.compute(), eager.compute())
        st = port._engine.stats
    assert st.dispatches == 0 and st.eager_fallbacks == len(batches)
    assert dict(st.fallback_reasons) == {reason: 1, "uncompilable-signature": len(batches) - 1}


def test_sdr_solve_capturable_rule(monkeypatch):
    """The CPU captures nothing, so its solve never blocks a graph; on CUDA the solve is
    refused where MAGMA is in the build and cuSOLVER was not chosen."""
    import torchmetrics_tpu_torch.functional.audio.sdr as sdr_mod

    assert sdr_mod._solve_capturable(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "has_magma", True)
    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", lambda *a: torch._C._LinalgBackend.Default)
    assert not sdr_mod._solve_capturable(torch.device("cuda"))
    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", lambda *a: torch._C._LinalgBackend.Cusolver)
    assert sdr_mod._solve_capturable(torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "has_magma", False)
    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library", lambda *a: torch._C._LinalgBackend.Default)
    assert sdr_mod._solve_capturable(torch.device("cuda"))


def _dns_batches(dc: float, n: int = 4) -> list:
    """``(preds, target)`` clips, each target with a DC offset of spread ``dc``."""
    rng = np.random.default_rng(55)
    out = []
    for _ in range(n):
        target = (rng.standard_normal((2, 300)) + dc * rng.standard_normal((2, 1))).astype(np.float32)
        out.append(((target + 0.3 * rng.standard_normal(target.shape)).astype(np.float32), target))
    return out


@pytest.mark.parametrize("dc, owners", [(0.0, ["si_sdr", "snr"]), (chip_smoke.DNS_DC, ["si_sdr", "si_snr", "snr"])])
def test_dns_collection_groups_as_in_jax(dc, owners):
    """The audio metrics share their state names, so a collection's discovery merges
    SI-SNR into SI-SDR's group when the first batch gives equal sums (zero-mean clips,
    where centring changes nothing at float32), in both packages; ``chip_smoke.py``'s
    ``dns`` clips carry DC offsets, which keep three groups."""
    import torchmetrics_tpu as jtm_root

    (preds, target), = _dns_batches(dc, n=1)
    if dc == 0.0:
        target = target - target.mean(-1, keepdims=True)
        preds = preds - preds.mean(-1, keepdims=True)
    port = ttm.MetricCollection(chip_smoke._dns_members("cpu"))
    ref = jtm_root.MetricCollection({"snr": ja.SignalNoiseRatio(), "si_snr": ja.ScaleInvariantSignalNoiseRatio(),
                                     "si_sdr": ja.ScaleInvariantSignalDistortionRatio()})
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert sorted(g.owner for g in port._groups.values()) == owners
    assert sorted(g.owner for g in ref._groups.values()) == owners


def test_dns_collection_replays_every_member():
    """The ``dns`` path's collection (SNR, SI-SNR, SI-SDR, three groups on clips with DC
    offsets) replays under the engine and equals the eager run."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import engine_context

    batches = _dns_batches(chip_smoke.DNS_DC)
    members = chip_smoke._dns_members
    with engine_context(True):
        mc = MetricCollection(members("cpu"))
        for preds, target in batches:
            mc.update(torch.from_numpy(preds), torch.from_numpy(target))
    with engine_context(False):
        eager = MetricCollection(members("cpu"))
        for preds, target in batches:
            eager.update(torch.from_numpy(preds), torch.from_numpy(target))
    got, want = mc.compute(), eager.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert len(mc._groups) == 3 and chip_smoke._audio_engine_fallbacks(mc) == 0
    assert mc._fused_engine is not None and mc._fused_engine.stats.dispatches == len(batches) - 1


# ---------------------------------------------------------------- PESQ and STOI

import torchmetrics_tpu_torch.audio.pesq as pesq_cls_mod  # noqa: E402
import torchmetrics_tpu_torch.audio.stoi as stoi_cls_mod  # noqa: E402
import torchmetrics_tpu_torch.functional.audio.pesq as pesq_mod  # noqa: E402
import torchmetrics_tpu_torch.functional.audio.stoi as stoi_mod  # noqa: E402


@pytest.fixture()
def fake_pesq(monkeypatch):
    """A fake ``pesq`` backend recording every call; score = mean(ref) - mean(deg)."""
    calls = {"pesq": [], "pesq_batch": []}
    mod = types.ModuleType("pesq")

    def _pesq(fs, ref, deg, mode):
        assert isinstance(fs, int) and mode in ("wb", "nb")
        ref, deg = np.asarray(ref), np.asarray(deg)
        assert ref.ndim == 1 and deg.ndim == 1, "backend receives 1-D host vectors"
        calls["pesq"].append((fs, ref.copy(), deg.copy(), mode))
        return float(ref.mean() - deg.mean())

    def _pesq_batch(fs, ref, deg, mode, n_processor=1):
        ref, deg = np.asarray(ref), np.asarray(deg)
        assert ref.ndim == 2 and deg.ndim == 2, "batch backend receives (N, T) host arrays"
        calls["pesq_batch"].append((fs, ref.copy(), deg.copy(), mode, n_processor))
        return [float(r.mean() - d.mean()) for r, d in zip(ref, deg)]

    mod.pesq, mod.pesq_batch = _pesq, _pesq_batch
    monkeypatch.setitem(sys.modules, "pesq", mod)
    monkeypatch.setattr(pesq_mod, "_PESQ_AVAILABLE", True)
    monkeypatch.setattr(pesq_cls_mod, "_PESQ_AVAILABLE", True)
    return calls


@pytest.fixture()
def fake_stoi(monkeypatch):
    calls = []
    mod = types.ModuleType("pystoi")

    def _stoi(ref, deg, fs_sig, extended=False):
        ref, deg = np.asarray(ref), np.asarray(deg)
        assert ref.ndim == 1 and deg.ndim == 1
        calls.append((ref.copy(), deg.copy(), fs_sig, extended))
        return float(ref.mean() - deg.mean())

    mod.stoi = _stoi
    monkeypatch.setitem(sys.modules, "pystoi", mod)
    monkeypatch.setattr(stoi_mod, "_PYSTOI_AVAILABLE", True)
    monkeypatch.setattr(stoi_cls_mod, "_PYSTOI_AVAILABLE", True)
    return calls


def test_pesq_argument_order_reshape_and_processes(fake_pesq):
    out = pesq_mod.perceptual_evaluation_speech_quality(torch.full((100,), 2.0), torch.full((100,), 5.0), 16000, "wb")
    assert float(out) == pytest.approx(3.0) and out.device.type == "cpu"
    (fs, ref, deg, mode), = fake_pesq["pesq"]  # target in the REFERENCE slot, preds in DEGRADED
    assert fs == 16000 and mode == "wb" and np.allclose(ref, 5.0) and np.allclose(deg, 2.0)
    preds, target = _signals(60, (2, 3, 64))
    out = pesq_mod.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), 8000, "nb")
    assert out.shape == (2, 3) and len(fake_pesq["pesq"]) == 7
    expected = target.reshape(-1, 64).mean(-1) - preds.reshape(-1, 64).mean(-1)
    np.testing.assert_allclose(out.numpy().reshape(-1), expected, atol=1e-6)
    out = pesq_mod.perceptual_evaluation_speech_quality(torch.from_numpy(preds), torch.from_numpy(target), 8000, "nb",
                                                        n_processes=3)
    (_, ref, deg, _, n_proc), = fake_pesq["pesq_batch"]
    assert n_proc == 3 and ref.shape == (6, 64) and out.shape == (2, 3)
    np.testing.assert_allclose(out.numpy().reshape(-1), expected, atol=1e-6)
    for args, match in (((44100, "wb"), "fs"), ((16000, "xx"), "mode")):
        with pytest.raises(ValueError, match=match):
            pesq_mod.perceptual_evaluation_speech_quality(torch.zeros(10), torch.zeros(10), *args)
    with pytest.raises(RuntimeError, match="shape"):
        pesq_mod.perceptual_evaluation_speech_quality(torch.zeros(10), torch.zeros(12), 16000, "wb")
    m = pesq_cls_mod.PerceptualEvaluationSpeechQuality(16000, "wb", device="cpu")
    m.update(torch.full((2, 50), 1.0), torch.full((2, 50), 3.0))
    m.update(torch.full((1, 50), 1.0), torch.full((1, 50), 7.0))
    assert float(m.compute()) == pytest.approx(10.0 / 3.0)
    with pytest.raises(ValueError, match="fs"):
        pesq_cls_mod.PerceptualEvaluationSpeechQuality(44100, "wb", device="cpu")


def test_stoi_argument_order_and_reshape(fake_stoi):
    out = stoi_mod.short_time_objective_intelligibility(torch.full((80,), 1.0), torch.full((80,), 4.0), 10000,
                                                        extended=True)
    assert float(out) == pytest.approx(3.0)
    (ref, deg, fs, extended), = fake_stoi
    assert np.allclose(ref, 4.0) and np.allclose(deg, 1.0) and fs == 10000 and extended is True
    preds, target = _signals(61, (3, 2, 48))
    out = stoi_mod.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 8000)
    assert out.shape == (3, 2) and len(fake_stoi) == 7
    expected = target.reshape(-1, 48).mean(-1) - preds.reshape(-1, 48).mean(-1)
    np.testing.assert_allclose(out.numpy().reshape(-1), expected, atol=1e-6)
    m = stoi_cls_mod.ShortTimeObjectiveIntelligibility(8000, device="cpu")
    m.update(torch.full((2, 40), 1.0), torch.full((2, 40), 2.0))
    assert float(m.compute()) == pytest.approx(1.0)


def test_missing_backends_raise_as_in_jax():
    if pesq_mod._PESQ_AVAILABLE or stoi_mod._PYSTOI_AVAILABLE:
        pytest.skip("real backends installed")
    import torchmetrics_tpu.functional.audio.pesq as jpesq
    import torchmetrics_tpu.functional.audio.stoi as jstoi

    x = np.zeros(10, np.float32)
    _raises_like_jax(lambda: pesq_mod.perceptual_evaluation_speech_quality(torch.from_numpy(x), torch.from_numpy(x),
                                                                           16000, "wb"),
                     lambda: jpesq.perceptual_evaluation_speech_quality(jnp.asarray(x), jnp.asarray(x), 16000, "wb"))
    _raises_like_jax(lambda: stoi_mod.short_time_objective_intelligibility(torch.from_numpy(x), torch.from_numpy(x),
                                                                           8000),
                     lambda: jstoi.short_time_objective_intelligibility(jnp.asarray(x), jnp.asarray(x), 8000))
    import torchmetrics_tpu.audio.pesq as jpesq_cls
    import torchmetrics_tpu.audio.stoi as jstoi_cls

    _raises_like_jax(lambda: pesq_cls_mod.PerceptualEvaluationSpeechQuality(16000, "wb", device="cpu"),
                     lambda: jpesq_cls.PerceptualEvaluationSpeechQuality(16000, "wb"))
    _raises_like_jax(lambda: stoi_cls_mod.ShortTimeObjectiveIntelligibility(8000, device="cpu"),
                     lambda: jstoi_cls.ShortTimeObjectiveIntelligibility(8000))
    assert set(ta.__all__) == set(ja.__all__) and set(tF.__all__) == set(jF.__all__)


# ---------------------------------------------------------------- exports and docs


def test_root_aliases_warn_and_domain_imports_do_not():
    names = [n for n in ta.__all__ if n != "ComplexScaleInvariantSignalNoiseRatio"]
    assert len(names) == 5 and set(ta.__all__) <= set(ttm.__all__)
    args = {"PermutationInvariantTraining": (tF.signal_noise_ratio,)}
    for name in names:
        with pytest.warns(DeprecationWarning, match=f"torchmetrics_tpu_torch.audio.{name}"):
            alias = getattr(ttm, name)(*args.get(name, ()), device="cpu")
        assert isinstance(alias, getattr(ta, name))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            getattr(ta, name)(*args.get(name, ()), device="cpu")
    assert ttm.ComplexScaleInvariantSignalNoiseRatio is ta.ComplexScaleInvariantSignalNoiseRatio
    assert {n for n in jtm.__all__ if n in ja.__all__} <= set(ttm.__all__)


@pytest.mark.parametrize(
    "module",
    [f"torchmetrics_tpu_torch.functional.audio.{m}" for m in ("snr", "sdr", "pit")]
    + [f"torchmetrics_tpu_torch.audio.{m}" for m in ("snr", "sdr", "pit")],
)
def test_docstring_examples(module):
    results = doctest.testmod(importlib.import_module(module), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted and not results.failed
