"""Sharded state on a ``(data 2, state 2)`` mesh of 4 gloo ranks, held against the JAX
package's ``tests/test_mesh2d.py`` tier.

Rank ``r`` sits at ``(r // 2, r % 2)``: the two ranks of a data row see that row's
half of every global batch (``sharding.shard_batch``), and split the class axis of each
sharded state between them. Until the sync each rank holds its own data row's
contribution; the sync folds a sharded state over the rank's ``data`` sub-group (one
all-reduce) and the replicated states over the same sub-group (the packed exchange),
so the synced ``compute()`` covers the whole stream and must equal the JAX package's
``compute()`` on the whole stream under its own 2x2 mesh. The JAX side runs in this
process on the conftest's virtual CPU devices; the mesh-policy checks that need no
ranks run here too.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import run_ranks
from torchmetrics_tpu.classification import (
    MulticlassAccuracy as JAcc,
    MulticlassAUROC as JAUROC,
    MulticlassConfusionMatrix as JCM,
    MulticlassStatScores as JSS,
)
from torchmetrics_tpu.engine import engine_context as j_engine
from torchmetrics_tpu.parallel import sharding as jsharding
from torchmetrics_tpu_torch.engine import statespec
from torchmetrics_tpu_torch.parallel import sharding
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

DATA = 2
STATE = 2
CLASSES = 32
BATCH = 64
N_BATCHES = 6
THRESHOLDS = 20


def _stream():
    rng = np.random.RandomState(13)
    return [
        (rng.rand(BATCH, CLASSES).astype(np.float32), rng.randint(0, CLASSES, BATCH).astype(np.int32))
        for _ in range(N_BATCHES)
    ]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's computes over the whole stream on its own 2x2 mesh."""
    stream = [(jnp.asarray(p), jnp.asarray(t)) for p, t in _stream()]
    out = {}
    with j_engine(True, donate=True), jsharding.mesh_context(data=DATA, state=STATE):
        for name, make in (
            ("confmat", lambda: JCM(CLASSES, validate_args=False)),
            ("stat_scores", lambda: JSS(CLASSES, average="macro", validate_args=False)),
            ("accuracy", lambda: JAcc(CLASSES, average="macro", validate_args=False)),
            ("auroc", lambda: JAUROC(CLASSES, thresholds=THRESHOLDS, validate_args=False)),
        ):
            m = make()
            for p, t in stream:
                m.update(p, t)
            out[name] = np.asarray(m.compute())
        assert jsharding.is_sharded(JCM(CLASSES, validate_args=False).confmat)
    out["sum"] = float(sum(float(p.sum()) for p, _ in _stream()))
    return out


_BODY = '''
def run(rank):
    import os, pickle
    import numpy as np
    import torch
    import torchmetrics_tpu_torch.classification as C
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import CatMetric, MeanMetric, SumMetric
    from torchmetrics_tpu_torch.engine import async_context, engine_context, engine_report, reset_engine_stats, scan_context
    from torchmetrics_tpu_torch.parallel import gather_all_tensors, packing, sharding
    from torchmetrics_tpu_torch.parallel.elastic import restore_resharded, save_state_shard, shard_path

    data = np.load(os.path.join(OUT, "inputs.npz"))
    glob = [(torch.from_numpy(data[f"p{i}"]), torch.from_numpy(data[f"t{i}"])) for i in range(N_BATCHES)]
    out = {}

    def run_stream(m, s):
        for p, t in s:
            m.update(p, t)
        return m.compute()

    def cm(**k):
        return C.MulticlassConfusionMatrix(CLASSES, validate_args=False, device="cpu", **k)

    with engine_context(True), sharding.mesh_context(data=DATA, state=STATE) as mesh:
        out["mesh"] = [list(mesh.axis_names), sharding.data_axis_size(), sharding.axis_size(), mesh.coordinate()]
        stream = [(sharding.shard_batch(p), sharding.shard_batch(t)) for p, t in glob]
        row = mesh.coordinate()["data"]
        out["rows"] = [torch.equal(stream[0][0], glob[0][0][row * BATCH // 2:(row + 1) * BATCH // 2]),
                       sharding.shard_batch(glob[0][0][:7]).shape[0]]

        m = cm()
        foot = m.state_footprint()
        out["born"] = [sharding.is_sharded(m.confmat), list(sharding.local(m.confmat).shape),
                       foot["per_device_bytes"] * STATE == foot["total_bytes"]]

        # the packed sync: one all-reduce over data for the sharded state, nothing packed
        reset_engine_stats()
        out["confmat"] = run_stream(m, stream).tolist()
        rep = engine_report()
        out["confmat_counters"] = [rep["sync_noop_plans"], rep["sync_collectives"], rep["sync_metadata_gathers"],
                                   rep["gather_skipped"], rep["psum_syncs"]]
        out["stat_scores"] = run_stream(C.MulticlassStatScores(CLASSES, average="macro", validate_args=False, device="cpu"), stream).tolist()
        out["accuracy"] = run_stream(C.MulticlassAccuracy(CLASSES, average="macro", validate_args=False, device="cpu"), stream).tolist()
        out["eager_confmat"] = run_stream(cm(dist_sync_fn=gather_all_tensors), stream).tolist()

        # before the fold a rank's compute holds its own data row only
        local = cm(sync_on_compute=False)
        with sharding.mesh_context(False):
            row_ref = run_stream(cm(sync_on_compute=False), stream)
        out["unsynced_is_row"] = torch.equal(run_stream(local, stream), row_ref)

        # config #2's collection: stat scores, the confusion matrix and binned AUROC
        reset_engine_stats()
        mc = MetricCollection({
            "acc": C.MulticlassAccuracy(CLASSES, average="macro", validate_args=False, device="cpu"),
            "cm": cm(),
            "auroc": C.MulticlassAUROC(CLASSES, thresholds=THRESHOLDS, validate_args=False, device="cpu"),
        })
        vals = run_stream(mc, stream)
        out["collection"] = {k: v.tolist() for k, v in vals.items()}
        rep = engine_report()
        out["collection_counters"] = [rep["ingraph_syncs"], rep["gather_skipped"], rep["packed_syncs"]]

        # replicated states sync over the data sub-group
        reset_engine_stats()
        s = SumMetric(device="cpu")
        mean = MeanMetric(device="cpu")
        cat = CatMetric(device="cpu")
        for p, _ in stream:
            s.update(p.sum())
            mean.update(p.mean())
        for p, _ in stream[:3]:
            cat.update(p.mean(dim=1))
        out["sum"] = float(s.compute())
        out["mean_ok"] = bool(torch.isfinite(mean.compute()))
        out["cat_rows"] = int(cat.compute().shape[0])
        rep = engine_report()
        out["replicated_counters"] = [rep["ingraph_syncs"], rep["psum_syncs"], rep["packed_syncs"]]

        # the mode classifier
        plan = packing.PackedSyncPlan([("", s)], DATA, None, group=mesh.group("data", "cpu"))
        degraded = packing.PackedSyncPlan([("", s)], DATA, (0,), group=mesh.group("data", "cpu"))
        out["modes"] = [packing.ingraph_sync_mode(plan, None, 1), packing.ingraph_sync_mode(plan, mesh, DATA),
                        packing.ingraph_sync_mode(degraded, mesh, DATA),
                        packing.ingraph_sync_mode(packing.PackedSyncPlan([("", s)], DATA), mesh, DATA)]

        # lifecycle on the 2x2 mesh
        src = cm(sync_on_compute=False)
        ref = run_stream(src, stream)
        clone = src.clone()
        restored = pickle.loads(pickle.dumps(src))
        src.persistent(True)
        fresh = cm(sync_on_compute=False)
        fresh.persistent(True)
        fresh.load_state_dict(src.state_dict())
        out["lifecycle"] = [sharding.is_sharded(clone.confmat), torch.equal(clone.compute(), ref),
                            sharding.is_sharded(restored.confmat), torch.equal(restored.compute(), ref),
                            sharding.is_sharded(fresh.confmat), torch.equal(fresh.compute(), ref)]
        base = os.path.join(OUT, f"ck{rank}", "ck")
        os.makedirs(os.path.dirname(base))
        for r in range(2):
            save_state_shard(src, shard_path(base, r, 2), rank=r, world_size=2)
        target = cm(sync_on_compute=False)
        restore_resharded(target, os.path.dirname(base), rank=0, world_size=1)
        out["reshard"] = [sharding.is_sharded(target.confmat),
                          torch.equal(sharding.assemble(target.confmat), 2 * sharding.assemble(src.confmat))]

        for k in (1, 8):
            with scan_context(k) if k > 1 else engine_context(True):
                out[f"scan{k}"] = run_stream(C.MulticlassStatScores(CLASSES, average="macro", validate_args=False, device="cpu"), stream).tolist()
        with scan_context(4), async_context(True):
            out["async"] = run_stream(C.MulticlassStatScores(CLASSES, average="macro", validate_args=False, device="cpu"), stream).tolist()
    return out
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2d")
    arrays = {}
    for i, (p, t) in enumerate(_stream()):
        arrays[f"p{i}"], arrays[f"t{i}"] = p, t
    np.savez(tmp / "inputs.npz", **arrays)
    consts = (
        f"OUT = {str(tmp)!r}\nDATA, STATE, CLASSES, BATCH, N_BATCHES, THRESHOLDS = "
        f"{DATA}, {STATE}, {CLASSES}, {BATCH}, {N_BATCHES}, {THRESHOLDS}\n"
    )
    return run_ranks(tmp, consts + _BODY, DATA * STATE)


# ------------------------------------------------------------------ mesh policy (no ranks)


def test_mesh2d_env_spec_errors(monkeypatch):
    """The 2-D env spellings raise as in the JAX package; "1x1" and friends name no mesh."""
    for bad in ("0x4", "2x0", "1x1", "axb", "2x"):
        for mod in (sharding, jsharding):
            monkeypatch.setenv(mod.SHARD_ENV_VAR, bad)
            with pytest.raises(Exception):
                mod.metric_mesh()


def test_mesh2d_rejects_mixed_and_oversized():
    with pytest.raises(TorchMetricsUserError, match="not both"):
        sharding.set_mesh(4, data=2)
    with pytest.raises(TorchMetricsUserError, match="ranks exist"):
        sharding.build_mesh(8, data=2)


def test_shard_batch_without_a_mesh_is_the_batch():
    x = torch.arange(32.0).reshape(8, 4)
    assert sharding.shard_batch(x) is x


def test_partition_rules_validate_eagerly():
    with pytest.raises(TorchMetricsUserError, match="axis"):
        sharding.set_partition_rules([(r"x$", ("banana",))])
    with pytest.raises(TorchMetricsUserError, match="regex"):
        sharding.set_partition_rules([("(", ("state",))])
    sharding.set_partition_rules(None)
    assert not sharding.partition_rules_active()


def test_partition_rule_matching():
    with sharding.partition_rules_context([(r"^MyMetric/confmat$", ("state",)), (r"tp$", None)]):
        assert sharding.match_partition_rule("confmat", "MyMetric") == (r"^MyMetric/confmat$", ("state",))
        assert sharding.match_partition_rule("confmat", "Other") is None
        assert sharding.match_partition_rule("tp") == (r"tp$", ())
    assert sharding.match_partition_rule("confmat", "MyMetric") is None


def test_multihost_spec_parser(monkeypatch):
    for mod in (sharding, jsharding):
        monkeypatch.delenv(mod.MULTIHOST_ENV_VAR, raising=False)
        assert mod.multihost_spec() is None
        for raw, want in (("0", None), ("off", None), ("1", {}), ("auto", {})):
            monkeypatch.setenv(mod.MULTIHOST_ENV_VAR, raw)
            assert mod.multihost_spec() == want
        monkeypatch.setenv(mod.MULTIHOST_ENV_VAR, "10.0.0.1:8476:4:2")
        assert mod.multihost_spec() == {"coordinator_address": "10.0.0.1:8476", "num_processes": 4, "process_id": 2}
        for bad in ("banana", "host:port:2:0", "1:2:3"):
            monkeypatch.setenv(mod.MULTIHOST_ENV_VAR, bad)
            with pytest.raises(Exception, match="multi-host spec"):
                mod.multihost_spec()


def test_ensure_multihost_is_off_without_the_knob(monkeypatch):
    monkeypatch.delenv(sharding.MULTIHOST_ENV_VAR, raising=False)
    assert sharding.ensure_multihost() is False


def test_knob_registry_names_the_mesh_knobs():
    import importlib

    from torchmetrics_tpu_torch.engine.config import KNOB_REGISTRY

    for knob in ("TORCHMETRICS_TPU_SHARD", "TORCHMETRICS_TPU_MULTIHOST"):
        module, attr = KNOB_REGISTRY[knob].split(":")
        assert callable(getattr(importlib.import_module(module), attr))


def test_degrade_is_counted_when_the_mesh_has_no_state_rank():
    from torchmetrics_tpu_torch.engine.stats import engine_report, reset_engine_stats

    reset_engine_stats()
    spec = statespec.StateSpec(name="tp", fold="sum", shard_rule="class_axis")
    mesh = sharding.StateMesh((sharding.DATA_AXIS, sharding.STATE_AXIS), np.arange(4).reshape(4, 1))
    with sharding.mesh_context(mesh):
        assert statespec.resolve_shard_rule(spec, torch.zeros(CLASSES)) is None
        assert statespec.resolve_shard_rule(spec, torch.zeros(())) is None
    assert engine_report()["shard_degrades"] == 2


# ------------------------------------------------------------------ on the ranks


def test_mesh2d_shape_and_coordinates(ranks):
    for rank, r in enumerate(ranks):
        assert r["mesh"] == [["data", "state"], DATA, STATE, {"data": rank // STATE, "state": rank % STATE}]
        assert r["rows"] == [True, 7]  # 7 rows do not divide over 2: the batch itself


def test_mesh2d_states_born_sharded(ranks):
    assert all(r["born"] == [True, [CLASSES // STATE, CLASSES], True] for r in ranks)


@pytest.mark.parametrize("name", ["confmat", "stat_scores", "accuracy", "eager_confmat"])
def test_mesh2d_synced_compute_equals_jax(ranks, jax_ref, name):
    want = jax_ref["confmat" if name == "eager_confmat" else name]
    for r in ranks:
        if name == "accuracy":
            np.testing.assert_allclose(np.asarray(r[name]), want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(np.asarray(r[name]), want)


def test_mesh2d_sharded_sync_is_one_fold_and_no_packing(ranks):
    for r in ranks:
        noop, collectives, meta, skipped, psum = r["confmat_counters"]
        assert noop >= 1 and meta == 0 and skipped >= 1 and psum >= 1
        assert collectives == 1  # the all-reduce over data


def test_mesh2d_unsynced_compute_holds_its_data_row(ranks):
    assert all(r["unsynced_is_row"] for r in ranks)


@pytest.mark.parametrize("member", ["acc", "cm", "auroc"])
def test_mesh2d_collection_equals_jax(ranks, jax_ref, member):
    want = jax_ref[{"acc": "accuracy", "cm": "confmat", "auroc": "auroc"}[member]]
    for r in ranks:
        got = np.asarray(r["collection"][member])
        if member == "cm":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        ingraph, skipped, packed = r["collection_counters"]
        assert ingraph >= 1 and skipped >= 1 and packed >= 1


def test_mesh2d_replicated_states_sync_over_data(ranks, jax_ref):
    for r in ranks:
        np.testing.assert_allclose(r["sum"], jax_ref["sum"], rtol=1e-6)
        assert r["mean_ok"] and r["cat_rows"] == 3 * BATCH
        ingraph, psum, packed = r["replicated_counters"]
        assert ingraph >= 3 and psum >= 2 and packed >= 3


def test_mesh2d_mode_resolution(ranks):
    assert all(r["modes"] == [None, "mesh", None, None] for r in ranks)


def test_mesh2d_clone_pickle_statedict_roundtrips(ranks):
    assert all(r["lifecycle"] == [True] * 6 for r in ranks)


def test_mesh2d_restore_resharded_n_to_m(ranks):
    assert all(r["reshard"] == [True, True] for r in ranks)


@pytest.mark.parametrize("key", ["scan1", "scan8", "async"])
def test_mesh2d_scan_and_async_carry_sharded_state(ranks, jax_ref, key):
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r[key]), jax_ref["stat_scores"])
