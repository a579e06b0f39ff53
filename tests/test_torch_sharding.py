"""Sharded state on a 1-D mesh of 4 gloo ranks (``parallel/sharding.py``), held against
the JAX package's ``tests/test_sharding.py`` suite.

The port runs on 4 CPU processes joined by gloo, one rank per mesh position, with
``device="cpu"``; the JAX package runs in this process on the conftest's virtual CPU
devices, its states placed on a 4-device mesh. The same seeded numpy stream (MESH = 4,
CLASSES = 32, BATCH = 64) goes through both: ``compute()`` of the stat-scores family,
both confusion matrices and ``PackedMeanAveragePrecision`` must be equal exactly, FID's
covariance sums within rtol 1e-6. One spawn of the ranks runs every check, and the
tests below read its results; the lifecycle checks (riders, scan K in {1, 8}, clone,
pickle and ``state_dict``, ``restore_resharded`` N -> M, ``snapshot_compute``, the sync
skips, counters, ``placement_token``) compare the sharded run with a replicated one on
the same ranks.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import run_ranks
from torchmetrics_tpu.classification import (
    MulticlassAccuracy as JAcc,
    MulticlassConfusionMatrix as JCM,
    MulticlassF1Score as JF1,
    MulticlassPrecision as JPrec,
    MulticlassRecall as JRec,
    MulticlassStatScores as JSS,
    MultilabelConfusionMatrix as JMLCM,
)
from torchmetrics_tpu.engine import engine_context as j_engine
from torchmetrics_tpu.parallel import sharding as jsharding
from torchmetrics_tpu_torch.engine import statespec
from torchmetrics_tpu_torch.interop import state_from_jax
from torchmetrics_tpu_torch.parallel import sharding
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

MESH = 4
CLASSES = 32
BATCH = 64
N_BATCHES = 8
LABELS = 8
D = 16  # FID feature width
MAP_CLASSES = 8


def _stream():
    rng = np.random.RandomState(7)
    return [
        (rng.rand(BATCH, CLASSES).astype(np.float32), rng.randint(0, CLASSES, BATCH).astype(np.int32))
        for _ in range(N_BATCHES)
    ]


def _ml_stream():
    rng = np.random.RandomState(11)
    return [
        (rng.rand(BATCH, LABELS).astype(np.float32), rng.randint(0, 2, (BATCH, LABELS)).astype(np.int32))
        for _ in range(4)
    ]


def _fid_stream():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, (6, 3, 8, 8)).astype(np.uint8), i % 2 == 0) for i in range(6)]


def _map_batches():
    from tests.test_torch_detection_map import coco_like, pack

    rng = np.random.RandomState(5)
    out = []
    for _ in range(3):
        preds, target = coco_like(int(rng.randint(1 << 30)), n_images=4, n_classes=MAP_CLASSES, max_gt=6, max_fp=4)
        p, t = pack(preds, target, width=16, gt_width=8)
        p["scores"] = np.round(p["scores"] * 256) / 256
        out.append((p, t))
    return out


FACTORIES = {
    "confmat": ("MulticlassConfusionMatrix", {}),
    "stat_scores": ("MulticlassStatScores", {"average": "macro"}),
    "accuracy": ("MulticlassAccuracy", {"average": "macro"}),
    "precision": ("MulticlassPrecision", {"average": "none"}),
    "recall": ("MulticlassRecall", {"average": "weighted"}),
    "f1": ("MulticlassF1Score", {"average": "macro"}),
}
_JAX_CLASSES = {
    "MulticlassConfusionMatrix": JCM, "MulticlassStatScores": JSS, "MulticlassAccuracy": JAcc,
    "MulticlassPrecision": JPrec, "MulticlassRecall": JRec, "MulticlassF1Score": JF1,
}


# ------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's sharded computes on a 4-device state mesh."""
    out = {}
    stream = [(jnp.asarray(p), jnp.asarray(t)) for p, t in _stream()]
    with j_engine(True, donate=True), jsharding.mesh_context(MESH):
        for name, (cls, kw) in FACTORIES.items():
            m = _JAX_CLASSES[cls](CLASSES, validate_args=False, **kw)
            assert jsharding.is_sharded(getattr(m, "confmat" if name == "confmat" else "tp"))
            for p, t in stream:
                m.update(p, t)
            out[name] = np.asarray(m.compute())
            if name == "confmat":
                # the JAX sharded state crosses as numpy (interop.state_from_jax)
                m.persistent(True)
                out["confmat_state"] = state_from_jax(m.state_dict(), "cpu")
        ml = JMLCM(LABELS, validate_args=False)
        for p, t in _ml_stream():
            ml.update(jnp.asarray(p), jnp.asarray(t))
        out["multilabel"] = np.asarray(ml.compute())
        from torchmetrics_tpu.image import FrechetInceptionDistance as JFID

        fid = JFID(lambda x: x.astype(jnp.float32).reshape(x.shape[0], -1)[:, :D] / 255.0, num_features=D)
        assert jsharding.is_sharded(fid.real_features_cov_sum)
        for x, real in _fid_stream():
            fid.update(jnp.asarray(x), real)
        out["fid_states"] = {k: np.asarray(getattr(fid, k)) for k in ("real_features_cov_sum", "fake_features_cov_sum", "real_features_sum")}
        out["fid"] = float(fid.compute())
        import torchmetrics_tpu.detection.ingraph as jingraph

        jm = jingraph.PackedMeanAveragePrecision(num_classes=MAP_CLASSES, score_bins=64, class_metrics=True)
        assert jsharding.is_sharded(jm.map_tp_hist)
        for p, t in _map_batches():
            jm.update(*jingraph.pack_detections(p, t))
        out["map"] = {k: np.asarray(v) for k, v in jm.compute().items()}
    return out


# ------------------------------------------------------------------ the ranks

_BODY = '''
def run(rank):
    import os, pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    import torchmetrics_tpu_torch.classification as C
    from torchmetrics_tpu_torch.detection import PackedMeanAveragePrecision
    from torchmetrics_tpu_torch.engine import (compensated_context, engine_context, engine_report,
                                              quarantine_context, reset_engine_stats, scan_context)
    from torchmetrics_tpu_torch.engine.compiled import CompiledUpdate
    from torchmetrics_tpu_torch.engine.txn import read_quarantine
    from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    from torchmetrics_tpu_torch.parallel import gather_all_tensors, sharding
    from torchmetrics_tpu_torch.parallel.elastic import (ContinuousSnapshotter, restore_latest,
                                                         restore_resharded, save_state_shard, shard_path)

    data = np.load(os.path.join(OUT, "inputs.npz"), allow_pickle=True)
    stream = [(torch.from_numpy(data[f"p{i}"]), torch.from_numpy(data[f"t{i}"])) for i in range(N_BATCHES)]
    out = {"values": {}, "born": {}, "shapes": {}}

    def make(name, **extra):
        cls, kw = FACTORIES[name]
        return getattr(C, cls)(CLASSES, validate_args=False, device="cpu", **kw, **extra)

    def run_stream(m, s=stream):
        for p, t in s:
            m.update(p, t)
        return m.compute()

    def local_run(factory, s=stream):
        # the one-process replicated reference: no sync across the ranks
        m = factory(sync_on_compute=False)
        return run_stream(m, s)

    calls = []
    for fn in ("all_gather", "all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor"):
        real = getattr(dist, fn)
        def counting(*a, _real=real, _fn=fn, **k):
            calls.append(_fn)
            return _real(*a, **k)
        setattr(dist, fn, counting)

    with engine_context(True), sharding.mesh_context(MESH):
        for name in FACTORIES:
            m = make(name)
            attr = "confmat" if name == "confmat" else "tp"
            out["born"][name] = sharding.is_sharded(getattr(m, attr)) and sharding.is_sharded(m._defaults[attr])
            out["shapes"][name] = list(sharding.local(getattr(m, attr)).shape)
            before = len(calls)
            for p, t in stream:
                m.update(p, t)
            out.setdefault("update_collectives", 0)
            out["update_collectives"] += len(calls) - before
            out["values"][name] = m.compute().tolist()
            replicated = local_run(lambda **k: make(name, **k))
            out.setdefault("replicated_equal", {})[name] = torch.equal(torch.as_tensor(out["values"][name]), replicated)
        # forward: the batch value and the accumulated state, sharded against replicated
        def forwards(m):
            return [m(p, t).tolist() for p, t in stream[:3]] + [m.compute().tolist()]
        fwd = forwards(make("accuracy"))
        with sharding.mesh_context(False):
            ref = forwards(make("accuracy", sync_on_compute=False))
        out["forward_equal"] = fwd == ref
        micro = C.MulticlassStatScores(CLASSES, average="micro", validate_args=False, device="cpu")
        out["micro_replicated"] = not sharding.is_sharded(micro.tp)

        cm = make("confmat")
        run_stream(cm)
        cm.reset()
        out["reset_keeps"] = sharding.is_sharded(cm.confmat) and int(sharding.local(cm.confmat).sum()) == 0
        foot = cm.state_footprint()
        out["footprint"] = [foot["per_device_bytes"], foot["total_bytes"]]

        ml = C.MultilabelConfusionMatrix(LABELS, validate_args=False, device="cpu")
        out["ml_born"] = sharding.is_sharded(ml.confmat)
        mls = [(torch.from_numpy(data[f"mlp{i}"]), torch.from_numpy(data[f"mlt{i}"])) for i in range(4)]
        out["values"]["multilabel"] = run_stream(ml, mls).tolist()

        # riders: quarantine rollback + compensated accumulation on sharded state
        nan = torch.full((BATCH, CLASSES), float("nan"))
        def riders(mesh):
            with quarantine_context(True), compensated_context(True):
                m = C.MulticlassStatScores(CLASSES, average="macro", validate_args=False, device="cpu",
                                           sync_on_compute=False)
                for i, (p, t) in enumerate(stream):
                    m.update(nan if i in (2, 5) else p, t)
                value = m.compute().tolist()
                states = {k: sharding.assemble(getattr(m, k)).tolist() for k in m._defaults}
                return value, states, int(read_quarantine(m)["count"]), sharding.is_sharded(m.tp)
        with sharding.mesh_context(False):
            rv = riders(False)
        sv = riders(True)
        out["riders"] = [rv[0] == sv[0], rv[1] == sv[1], rv[2], sv[2], sv[3]]

        # the scan queue at K in {1, 8}
        for k in (1, 8):
            with scan_context(k) if k > 1 else engine_context(True):
                m = C.MulticlassStatScores(CLASSES, average="macro", validate_args=False, device="cpu")
                out["values"][f"scan{k}"] = run_stream(m).tolist()

        # the packed sync skips sharded states; the eager sync skips them too
        reset_engine_stats()
        m = make("confmat")
        synced = run_stream(m)
        rep = engine_report()
        out["packed_skip"] = [rep["gather_skipped"], rep["psum_syncs"], rep["packed_syncs"], rep["sync_noop_plans"]]
        out["packed_equal"] = torch.equal(synced, local_run(lambda **k: make("confmat", **k)))
        m = make("confmat", dist_sync_fn=gather_all_tensors)
        out["eager_equal"] = torch.equal(run_stream(m), local_run(lambda **k: make("confmat", **k)))

        # clone, pickle and state_dict keep (or re-place) the placement
        src = make("confmat")
        ref = run_stream(src)
        clone = src.clone()
        restored = pickle.loads(pickle.dumps(src))
        src.persistent(True)
        fresh = make("confmat")
        fresh.persistent(True)
        sd = src.state_dict()
        fresh.load_state_dict(sd)
        out["lifecycle"] = [
            sharding.is_sharded(clone.confmat), torch.equal(clone.compute(), ref),
            sharding.is_sharded(restored.confmat), torch.equal(restored.compute(), ref),
            list(sd["confmat"].shape), sharding.is_sharded(fresh.confmat), torch.equal(fresh.compute(), ref),
        ]

        # a JAX sharded state, carried over by interop.state_from_jax, re-placed here
        carried = make("confmat")
        carried.load_state_dict({"confmat": torch.from_numpy(data["jax_confmat"]),
                                 "_update_count": int(data["jax_count"])})
        out["from_jax"] = [sharding.is_sharded(carried.confmat), carried.compute().tolist()]

        # restore_resharded from a 2-shard snapshot into a world of 1
        base = os.path.join(OUT, f"ck{rank}", "ck")
        os.makedirs(os.path.dirname(base))
        for r in range(2):
            save_state_shard(src, shard_path(base, r, 2), rank=r, world_size=2)
        target = make("confmat")
        restore_resharded(target, os.path.dirname(base), rank=0, world_size=1)
        out["reshard"] = [sharding.is_sharded(target.confmat),
                          torch.equal(sharding.assemble(target.confmat), 2 * sharding.assemble(src.confmat))]

        # snapshot_compute leaves the live placement alone
        m = make("confmat")
        for p, t in stream[:3]:
            m.update(p, t)
        value = m.snapshot_compute()
        out["snapshot"] = [list(value.shape), sharding.is_sharded(m.confmat)]

        # continuous snapshots flush and restore sharded state
        snapdir = os.path.join(OUT, f"snap{rank}")
        snap = ContinuousSnapshotter(src, snapdir)
        snap.flush("test")
        again = make("confmat")
        restore_latest(again, snapdir)
        out["continuous"] = [sharding.is_sharded(again.confmat),
                             torch.equal(sharding.assemble(again.confmat), sharding.assemble(src.confmat))]

        # counters reach the exposition
        reset_engine_stats()
        m = make("confmat")
        run_stream(m)
        from torchmetrics_tpu_torch.diag import diag_context, export_prometheus
        rep = engine_report()
        text = export_prometheus()
        out["counters"] = [rep["shard_states"]] + [s in text for s in (
            "tm_tpu_shard_states_total", "tm_tpu_psum_syncs_total", "tm_tpu_gather_skipped_total",
            "tm_tpu_shard_degrades_total", "tm_tpu_sync_noop_plans_total")] + ['mesh="state=4"' in text]

        # the degrade: 33 classes do not divide over 4 ranks
        reset_engine_stats()
        with diag_context() as rec:
            odd = C.MulticlassAccuracy(CLASSES + 1, average="macro", validate_args=False, device="cpu")
        out["degrade"] = [sharding.is_sharded(odd.tp), engine_report()["shard_degrades"], rec.count("shard.fallback")]

        # placement tokens name the placement
        plain = {"s": torch.zeros(CLASSES, dtype=torch.int32)}
        placed = {"s": make("confmat").confmat}
        out["token"] = [CompiledUpdate._device_token(plain), CompiledUpdate._device_token(placed)]

        # FID's covariance sums, row-sharded
        ext = lambda x: x.to(torch.float32).reshape(x.shape[0], -1)[:, :D] / 255.0
        fid = FrechetInceptionDistance(ext, num_features=D, device="cpu")
        out["fid_born"] = sharding.is_sharded(fid.real_features_cov_sum)
        for i in range(6):
            fid.update(torch.from_numpy(data[f"fid{i}"]), bool(data[f"fidr{i}"]))
        out["fid_states"] = {k: sharding.assemble(getattr(fid, k)).tolist()
                             for k in ("real_features_cov_sum", "fake_features_cov_sum", "real_features_sum")}
        out["fid"] = float(fid.compute())

        # PackedMeanAveragePrecision's histograms, class-sharded
        pm = PackedMeanAveragePrecision(num_classes=MAP_CLASSES, score_bins=64, class_metrics=True, device="cpu")
        out["map_born"] = sharding.is_sharded(pm.map_tp_hist)
        for i in range(3):
            pm.update(*(torch.from_numpy(data[f"map{i}_{j}"]) for j in range(4)))
        out["map"] = {k: v.tolist() for k, v in pm.compute().items()}
    return out
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_ref):
    import torchmetrics_tpu_torch.detection.ingraph as tingraph

    tmp = tmp_path_factory.mktemp("mesh1d")
    arrays = {
        "jax_confmat": jax_ref["confmat_state"]["confmat"].numpy(),
        "jax_count": np.asarray(jax_ref["confmat_state"]["_update_count"]),
    }
    for i, (p, t) in enumerate(_stream()):
        arrays[f"p{i}"], arrays[f"t{i}"] = p, t
    for i, (p, t) in enumerate(_ml_stream()):
        arrays[f"mlp{i}"], arrays[f"mlt{i}"] = p, t
    for i, (x, real) in enumerate(_fid_stream()):
        arrays[f"fid{i}"], arrays[f"fidr{i}"] = x, np.asarray(real)
    for i, (p, t) in enumerate(_map_batches()):
        for j, a in enumerate(tingraph.pack_detections(p, t)):
            arrays[f"map{i}_{j}"] = a.numpy()
    np.savez(tmp / "inputs.npz", **arrays)
    consts = (
        f"OUT = {str(tmp)!r}\nMESH, CLASSES, BATCH, N_BATCHES, LABELS, D, MAP_CLASSES = "
        f"{MESH}, {CLASSES}, {BATCH}, {N_BATCHES}, {LABELS}, {D}, {MAP_CLASSES}\nFACTORIES = {FACTORIES!r}\n"
    )
    return run_ranks(tmp, consts + _BODY, MESH)


# ------------------------------------------------------------------ mesh policy (no ranks)


def test_mesh_policy_without_ranks(monkeypatch):
    """One process: no mesh is active, a 1-rank mesh and an oversized one raise, and a
    bad env value raises, with the JAX package's messages (ranks for devices)."""
    assert sharding.metric_mesh() is None and jsharding.metric_mesh() is None
    assert sharding.axis_size() == 1 and sharding.data_axis_size() == 1
    with pytest.raises(TorchMetricsUserError, match=">= 2"):
        sharding.build_mesh(1)
    with pytest.raises(TorchMetricsUserError, match="ranks exist"):
        sharding.build_mesh(MESH)
    for name, mod in (("port", sharding), ("jax", jsharding)):
        monkeypatch.setenv(mod.SHARD_ENV_VAR, "banana")
        with pytest.raises(Exception, match="banana"):
            mod.metric_mesh()
        monkeypatch.delenv(mod.SHARD_ENV_VAR)


def test_shard_rules_registered_and_resolve_without_a_mesh():
    assert set(statespec.SHARD_RULES) == {"replicate", "class_axis", "row_sharded"}
    spec = statespec.StateSpec(name="tp", fold="sum", shard_rule="class_axis")
    assert statespec.resolve_shard_rule(spec, torch.zeros(CLASSES)) is None


def test_unknown_shard_rule_lists_registered_rules():
    spec = statespec.StateSpec(name="tp", shard_rule="nope")
    with pytest.raises(ValueError, match="registered rules"):
        statespec.resolve_shard_rule(spec)
    with pytest.raises(ValueError, match="registered rules"):
        statespec.build_spec(object(), "tp", None, {"shard_rule": "nope"})


def test_placement_token_before_any_placement():
    from torchmetrics_tpu_torch.engine.compiled import CompiledUpdate

    token = CompiledUpdate._device_token({"s": torch.zeros(CLASSES, dtype=torch.int32)})
    assert token == "cpu" and "@" not in token


# ------------------------------------------------------------------ values against JAX


#: the counts are held exactly; the ratios to float32 rounding (the JAX package runs
#: them in float64 under the tests' x64 mode), as the port's classification parity does
RATIO_RTOL = 1e-6


@pytest.mark.parametrize("name", list(FACTORIES))
def test_sharded_compute_equals_jax(ranks, jax_ref, name):
    for r in ranks:
        assert r["born"][name], name
        got = np.asarray(r["values"][name])
        if name in ("confmat", "stat_scores"):
            np.testing.assert_array_equal(got, jax_ref[name], err_msg=name)
        else:
            np.testing.assert_allclose(got, jax_ref[name], rtol=RATIO_RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("name", list(FACTORIES))
def test_sharded_equals_replicated_on_the_ranks(ranks, name):
    assert all(r["replicated_equal"][name] for r in ranks)


def test_per_rank_shard_is_one_quarter(ranks):
    for r in ranks:
        assert r["shapes"]["confmat"] == [CLASSES // MESH, CLASSES]
        assert r["shapes"]["accuracy"] == [CLASSES // MESH]
        per_device, total = r["footprint"]
        assert per_device * MESH == total


def test_update_loop_issues_no_collective(ranks):
    assert all(r["update_collectives"] == 0 for r in ranks)


def test_forward_on_sharded_state(ranks):
    assert all(r["forward_equal"] for r in ranks)


def test_micro_counters_and_reset(ranks):
    assert all(r["micro_replicated"] and r["reset_keeps"] for r in ranks)


def test_multilabel_confmat_equals_jax(ranks, jax_ref):
    for r in ranks:
        assert r["ml_born"]
        np.testing.assert_array_equal(np.asarray(r["values"]["multilabel"]), jax_ref["multilabel"])


def test_fid_covariance_sums_equal_jax(ranks, jax_ref):
    for r in ranks:
        assert r["fid_born"]
        for k, want in jax_ref["fid_states"].items():
            np.testing.assert_allclose(np.asarray(r["fid_states"][k]), want, rtol=1e-6, atol=0, err_msg=k)
        np.testing.assert_allclose(r["fid"], jax_ref["fid"], rtol=1e-6)


def test_packed_map_equals_jax(ranks, jax_ref):
    for r in ranks:
        assert r["map_born"]
        assert set(r["map"]) == set(jax_ref["map"])
        for k, want in jax_ref["map"].items():
            np.testing.assert_array_equal(np.asarray(r["map"][k], dtype=want.dtype), want, err_msg=k)


# ------------------------------------------------------------------ lifecycle


def test_riders_survive_sharded_placement(ranks):
    for r in ranks:
        value_eq, states_eq, rq, sq, placed = r["riders"]
        assert value_eq and states_eq and placed
        assert rq == sq == 2


@pytest.mark.parametrize("k", [1, 8])
def test_scan_queue_carries_sharded_state(ranks, jax_ref, k):
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["values"][f"scan{k}"]), jax_ref["stat_scores"])


def test_packed_sync_skips_sharded_states(ranks):
    for r in ranks:
        skipped, psum, packed, noop = r["packed_skip"]
        assert skipped >= 1 and psum >= 1 and packed >= 1 and noop >= 1
        assert r["packed_equal"]


def test_eager_sync_skips_sharded_states(ranks):
    assert all(r["eager_equal"] for r in ranks)


def test_clone_pickle_statedict_roundtrips(ranks):
    for r in ranks:
        c_sharded, c_equal, p_sharded, p_equal, sd_shape, f_sharded, f_equal = r["lifecycle"]
        assert c_sharded and c_equal and p_sharded and p_equal and f_sharded and f_equal
        assert sd_shape == [CLASSES, CLASSES]  # state_dict writes the whole state


def test_jax_sharded_state_carries_into_the_mesh(ranks, jax_ref):
    for r in ranks:
        placed, value = r["from_jax"]
        assert placed
        np.testing.assert_array_equal(np.asarray(value), jax_ref["confmat"])


def test_restore_resharded_n_to_m(ranks):
    assert all(r["reshard"] == [True, True] for r in ranks)


def test_snapshot_compute_on_sharded_state(ranks):
    assert all(r["snapshot"] == [[CLASSES, CLASSES], True] for r in ranks)


def test_continuous_snapshot_restore_latest(ranks):
    assert all(r["continuous"] == [True, True] for r in ranks)


def test_shard_counters_exported(ranks):
    for r in ranks:
        assert r["counters"][0] >= 1 and all(r["counters"][1:])


def test_indivisible_state_degrades_and_is_counted(ranks):
    for r in ranks:
        sharded, degrades, events = r["degrade"]
        assert not sharded and degrades == 4 and events == 4  # tp, fp, tn, fn


def test_placement_token_distinguishes_placements(ranks):
    for r in ranks:
        plain, placed = r["token"]
        assert "@" not in plain and plain != placed and "state" in placed


def test_json_results_are_rank_symmetric(ranks):
    """Every rank computed the same values (the compute assembles the whole state)."""
    first = json.dumps(ranks[0]["values"], sort_keys=True)
    assert all(json.dumps(r["values"], sort_keys=True) == first for r in ranks[1:])
