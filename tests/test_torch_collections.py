"""MetricCollection: the port (on the CPU) against the JAX package's.

The same members on both sides, the same seeded numpy batches. Compute groups must be
identical after construction and after the first ``update`` for: an all-signature
collection (merged by reduction signature when built), a mixed one with AUROC
(value discovery at the first step), the signature veto, an explicit
``compute_groups`` list and ``compute_groups=False``. ``forward`` and ``compute``
dicts agree (counts exactly, accuracies to 1e-6, AUROC to 1e-5), with prefixes,
postfixes and nested collections; ``reset``, ``clone`` and the state-dict round trip
hold. Two port-only checks: views that share the owner's tensors stay right when
``update`` and ``forward`` interleave, and the freshness marker that lets signature
fusion happen when the collection is built.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu import MetricCollection as JaxMetricCollection
from torchmetrics_tpu.engine.statespec import cse_context as jax_cse_context
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.engine.statespec import cse_context
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

C, T, N_BATCHES, BATCH = 5, 11, 4, 48
ATOL = {"acc": 1e-6, "auroc": 1e-5}

ALL_SIGNATURE = {
    "acc": ("MulticlassAccuracy", dict(num_classes=C)),
    "acc_w": ("MulticlassAccuracy", dict(num_classes=C, average="weighted")),
    "acc_micro": ("MulticlassAccuracy", dict(num_classes=C, average="micro")),
    "stats": ("MulticlassStatScores", dict(num_classes=C)),
    "cm": ("MulticlassConfusionMatrix", dict(num_classes=C)),
    "cm_t": ("MulticlassConfusionMatrix", dict(num_classes=C, normalize="true")),
}
MIXED = {
    "acc": ("MulticlassAccuracy", dict(num_classes=C)),
    "acc_w": ("MulticlassAccuracy", dict(num_classes=C, average="weighted")),
    "auroc": ("MulticlassAUROC", dict(num_classes=C, thresholds=T)),
    "auroc_w": ("MulticlassAUROC", dict(num_classes=C, thresholds=T, average="weighted")),
    "auroc_exact": ("MulticlassAUROC", dict(num_classes=C)),
    "cm": ("MulticlassConfusionMatrix", dict(num_classes=C)),
    "cm_t": ("MulticlassConfusionMatrix", dict(num_classes=C, normalize="true")),
}
# no label is -1 or -100, so both accuracies hold equal states after any batch
VETO = {
    "acc_a": ("MulticlassAccuracy", dict(num_classes=C, ignore_index=-1)),
    "acc_b": ("MulticlassAccuracy", dict(num_classes=C, ignore_index=-100)),
    "auroc": ("MulticlassAUROC", dict(num_classes=C, thresholds=T)),
}


def _members(spec, port: bool):
    if port:
        return {name: getattr(tc, cls)(**kw, device="cpu") for name, (cls, kw) in spec.items()}
    return {name: getattr(jc, cls)(**kw) for name, (cls, kw) in spec.items()}


def _pair(spec, **kwargs):
    return MetricCollection(_members(spec, True), **kwargs), JaxMetricCollection(_members(spec, False), **kwargs)


def _batches(seed: int, n_batches: int = N_BATCHES):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        logits = rng.standard_normal((BATCH, C)).astype(np.float32)
        e = np.exp(logits - logits.max(1, keepdims=True))
        out.append(((e / e.sum(1, keepdims=True)).astype(np.float32), rng.integers(0, C, BATCH)))
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_values(port: dict, ref: dict) -> None:
    assert sorted(port) == sorted(ref)
    for key, value in port.items():
        got, want = _np(value), np.asarray(ref[key])
        if got.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            # rtol: macro stat scores are float32 means of counts near 30, where one
            # ulp (summed in another order) is 2e-6
            atol = ATOL["auroc"] if "auroc" in key else ATOL["acc"]
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-6, err_msg=key)


def _assert_states(port: MetricCollection, ref: JaxMetricCollection) -> None:
    for name, metric in port.items(keep_base=True):
        other = ref[name]
        for attr in metric._defaults:
            p, r = getattr(metric, attr), getattr(other, attr)
            if isinstance(p, list):
                p, r = torch.cat(p), np.concatenate([np.asarray(x) for x in r])
            np.testing.assert_array_equal(_np(p), np.asarray(r), err_msg=f"{name}.{attr}")


def _update_both(port, ref, preds, target):
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))


def _discovered_by_jax(spec) -> dict:
    """The JAX collection's groups after its first update (value discovery)."""
    ref = JaxMetricCollection(_members(spec, False))
    ref.update(*(jnp.asarray(x) for x in _batches(seed=2)[0]))
    return ref.compute_groups


@pytest.mark.parametrize(
    ("spec", "kwargs", "settled_when_built"),
    [
        (ALL_SIGNATURE, {}, (True, True)),
        (MIXED, {}, (False, False)),
        (VETO, {}, (True, False)),
        (
            MIXED,
            dict(compute_groups=[["acc", "acc_w"], ["auroc", "auroc_w"], ["auroc_exact"], ["cm", "cm_t"]]),
            (True, True),
        ),
        (MIXED, dict(compute_groups=False), (False, False)),
    ],
    ids=["all-signature", "mixed", "veto", "explicit", "off"],
)
def test_compute_groups_match_jax(spec, kwargs, settled_when_built):
    """``settled_when_built``: (port, JAX). The binned multiclass AUROC declares a
    reduction signature, which the JAX package's does not: the port builds at once the
    groups the JAX package reaches at its first update, and a collection whose every
    member declares one (``veto``) has nothing left to discover."""
    port, ref = _pair(spec, **kwargs)
    assert (port._groups_checked, ref._groups_checked) == settled_when_built
    built = port.compute_groups
    batches = _batches(seed=1)
    _update_both(port, ref, *batches[0])
    assert port.compute_groups == ref.compute_groups == built
    _assert_states(port, ref)
    for preds, target in batches[1:]:
        _update_both(port, ref, preds, target)
    assert port.compute_groups == ref.compute_groups
    _assert_states(port, ref)
    _assert_values(port.compute(), ref.compute())


def test_expected_groups():
    """What the parity above holds, spelled out: signature fusion (the binned AUROCs
    too), value discovery (which finds nothing more here), veto."""
    port = MetricCollection(_members(MIXED, True))
    assert port.compute_groups == {0: ["acc", "acc_w"], 1: ["auroc", "auroc_w"], 2: ["auroc_exact"], 3: ["cm", "cm_t"]}
    port.update(*(torch.from_numpy(x) for x in _batches(seed=2)[0]))
    assert port.compute_groups == {0: ["acc", "acc_w"], 1: ["auroc", "auroc_w"], 2: ["auroc_exact"], 3: ["cm", "cm_t"]}
    veto = MetricCollection(_members(VETO, True))
    veto.update(*(torch.from_numpy(x) for x in _batches(seed=2)[0]))
    assert len(veto.compute_groups) == 3  # equal states, but the signatures differ


@pytest.mark.parametrize("cse", [False, True])
def test_cse_switch_matches_jax(cse):
    """With signature fusion off, both packages fall back to value discovery, which
    merges the two accuracies of the veto case (their states are equal)."""
    with cse_context(cse), jax_cse_context(cse):
        port, ref = _pair(VETO)
        assert port.compute_groups == ref.compute_groups
        _update_both(port, ref, *_batches(seed=3)[0])
    assert port.compute_groups == ref.compute_groups
    assert len(port.compute_groups) == (3 if cse else 2)


@pytest.mark.parametrize("spec", [ALL_SIGNATURE, MIXED], ids=["all-signature", "mixed"])
@pytest.mark.parametrize(("prefix", "postfix"), [(None, None), ("val_", None), (None, "_ep"), ("val_", "_ep")])
def test_forward_and_compute_match_jax(spec, prefix, postfix):
    """``forward`` never runs the JAX collection's value discovery, so its groups stay
    as built; the port's are the ones that discovery finds (the binned AUROCs declare
    a reduction signature), and every value agrees."""
    port, ref = _pair(spec, prefix=prefix, postfix=postfix)
    for preds, target in _batches(seed=4):
        _assert_values(
            port(torch.from_numpy(preds), torch.from_numpy(target)), ref(jnp.asarray(preds), jnp.asarray(target))
        )
    assert port.compute_groups == _discovered_by_jax(spec)
    _assert_values(port.compute(), ref.compute())
    assert list(port.keys()) == list(ref.keys())


def test_nested_collections_match_jax():
    def build(pkg_collection, port: bool):
        inner = pkg_collection(_members(ALL_SIGNATURE, port), prefix="in_", postfix="_x")
        extra = _members({"auroc": MIXED["auroc"]}, port)["auroc"]
        by_dict = pkg_collection({"outer": inner, "auroc": extra})
        inner2 = pkg_collection(_members({"cm": ALL_SIGNATURE["cm"]}, port), prefix="seq_")
        seq_extra = _members({"acc": ALL_SIGNATURE["acc_w"]}, port)["acc"]
        by_seq = pkg_collection([inner2, seq_extra])
        return by_dict, by_seq

    port_dict, port_seq = build(MetricCollection, True)
    ref_dict, ref_seq = build(JaxMetricCollection, False)
    for port, ref in ((port_dict, ref_dict), (port_seq, ref_seq)):
        assert list(port.keys()) == list(ref.keys())
        assert port.compute_groups == ref.compute_groups
        for preds, target in _batches(seed=5):
            _assert_values(
                port(torch.from_numpy(preds), torch.from_numpy(target)),
                ref(jnp.asarray(preds), jnp.asarray(target)),
            )
        assert port.compute_groups == ref.compute_groups
        _assert_values(port.compute(), ref.compute())


def test_reset_clone_and_state_dict_round_trip():
    port, ref = _pair(MIXED)
    port.persistent(True)
    ref.persistent(True)
    batches = _batches(seed=6)
    for preds, target in batches[:2]:
        _update_both(port, ref, preds, target)

    # state_dict: same keys and values as the JAX package's; loads into a fresh collection
    sd, ref_sd = port.state_dict(), ref.state_dict()
    assert sorted(sd) == sorted(ref_sd)
    for key, value in sd.items():
        if isinstance(value, int):
            assert value == ref_sd[key], key
        elif isinstance(value, list):
            np.testing.assert_array_equal(_np(torch.cat(value)), np.concatenate([np.asarray(v) for v in ref_sd[key]]))
        else:
            np.testing.assert_array_equal(_np(value), np.asarray(ref_sd[key]), err_msg=key)
    restored = MetricCollection(_members(MIXED, True))
    restored.load_state_dict(sd)
    _assert_values(restored.compute(), ref.compute())

    # clone: a deep copy that goes its own way
    twin = port.clone(prefix="twin_")
    assert list(twin.keys()) == [f"twin_{k}" for k in port.keys()]
    _update_both(port, ref, *batches[2])
    twin_values = twin.compute()
    _assert_values(port.compute(), ref.compute())
    assert not torch.equal(twin_values["twin_cm"], port.compute()["cm"])

    # reset: back to defaults, groups kept, the next epoch as from scratch
    groups = port.compute_groups
    port.reset()
    ref.reset()
    assert port.compute_groups == groups == ref.compute_groups
    for name, metric in port.items(keep_base=True):
        assert metric.update_count == 0, name
    _update_both(port, ref, *batches[3])
    fresh = MetricCollection(_members(MIXED, True))
    fresh.update(*(torch.from_numpy(x) for x in batches[3]))
    _assert_values(port.compute(), fresh.compute())
    _assert_values(port.compute(), ref.compute())


@pytest.mark.parametrize("spec", [ALL_SIGNATURE, MIXED], ids=["all-signature", "mixed"])
def test_views_stay_right_when_update_and_forward_interleave(spec):
    """Views share the owner's tensors (and lists); every member must still equal the
    same metric run alone through the same calls."""
    mc = MetricCollection(_members(spec, True))
    alone = _members(spec, True)
    steps = ["update", "forward", "update", "read", "update", "forward", "forward", "read", "update"]
    batches = _batches(seed=7, n_batches=len(steps))
    for step, (preds, target) in zip(steps, batches):
        p, t = torch.from_numpy(preds), torch.from_numpy(target)
        if step == "update":
            mc.update(p, t)
            for m in alone.values():
                m.update(p, t)
        elif step == "forward":
            _assert_values(mc(p, t), {name: m(p, t) for name, m in alone.items()})
        else:  # an accessor with copies: views get clones, then the owner moves on
            copies = {name: mc[name] for name in alone}
            for name, m in alone.items():
                for attr in m._defaults:
                    value = getattr(copies[name], attr)
                    want = getattr(m, attr)
                    if isinstance(value, list):
                        assert all(torch.equal(a, b) for a, b in zip(value, want)) and len(value) == len(want)
                    else:
                        assert torch.equal(value, want), f"{name}.{attr}"
    _assert_values(mc.compute(), {name: m.compute() for name, m in alone.items()})
    for name, m in alone.items():
        assert mc[name].update_count == m.update_count, name


def test_freshness_marker():
    """``add_state`` and ``reset`` leave a metric fresh; a write to a state clears it;
    ``to`` keeps it. Fusion when the collection is built needs it."""
    m = tc.MulticlassAccuracy(num_classes=C, device="cpu")
    assert m._state_fresh
    preds, target = (torch.from_numpy(x) for x in _batches(seed=8)[0])
    m.update(preds, target)
    assert not m._state_fresh
    m.reset()
    assert m._state_fresh
    m.to("cpu")
    assert m._state_fresh
    other = tc.MulticlassAccuracy(num_classes=C, device="cpu")
    other.update(preds, target)
    m.merge_state(other)
    assert not m._state_fresh
    m.reset()
    m.load_state_dict({"tp": torch.ones(C, dtype=torch.int32)})
    assert not m._state_fresh

    # an all-signature collection is settled when built: one update per group from step 1
    mc = MetricCollection(_members(ALL_SIGNATURE, True))
    assert mc._groups_checked and len(mc.compute_groups) == 3

    # a member updated before it joined is not fresh: it keeps value discovery, as in JAX
    def with_used_member(port: bool):
        members = _members(ALL_SIGNATURE, port)
        if port:
            members["acc_w"].update(preds, target)
            return MetricCollection(members)
        members["acc_w"].update(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
        return JaxMetricCollection(members)

    port, ref = with_used_member(True), with_used_member(False)
    assert not port._groups_checked and not ref._groups_checked
    assert port.compute_groups == ref.compute_groups
    _update_both(port, ref, preds.numpy(), target.numpy())
    assert port.compute_groups == ref.compute_groups
    assert ["acc_w"] in port.compute_groups.values()


def test_engine_knobs_take_only_their_off_values():
    """``fused_dispatch`` takes None, True or False (a bool or None, as in the JAX
    package); the scan and async knobs take the JAX package's values, coerced as its
    ``coerce_k`` / ``coerce_inflight`` do, and reject the rest with its messages."""
    members = _members({"acc": ALL_SIGNATURE["acc"]}, True)
    ref_members = _members({"acc": ALL_SIGNATURE["acc"]}, False)
    for value in (None, True, False):
        assert MetricCollection(dict(members), fused_dispatch=value).fused_dispatch is value
    with pytest.raises(ValueError, match="fused_dispatch"):
        MetricCollection(dict(members), fused_dispatch=4)
    accepted = {"scan_steps": (None, False, 0, 4, 1024), "async_dispatch": (None, False, 0, True, 4, 16)}
    rejected = {"scan_steps": (True, 1, 1025, "4"), "async_dispatch": (-1, 17, 0.5)}
    for knob in accepted:
        for value in accepted[knob]:
            port = getattr(MetricCollection(dict(members), **{knob: value}), knob)
            ref = getattr(JaxMetricCollection(dict(ref_members), **{knob: value}), knob)
            assert port == ref and type(port) is type(ref), (knob, value, port, ref)
        for value in rejected[knob]:
            with pytest.raises(Exception) as jax_err:
                JaxMetricCollection(dict(ref_members), **{knob: value})
            with pytest.raises(TorchMetricsUserError) as port_err:
                MetricCollection(dict(members), **{knob: value})
            assert str(port_err.value) == str(jax_err.value)
