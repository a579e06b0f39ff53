"""Elastic snapshots (``parallel/elastic.py``), held against the JAX package.

- The elastic tests of ``tests/test_checkpoint.py`` run through both packages on the
  same seeded inputs: 2 -> 1, 2 -> 3 and same-world restores, ``cat`` lists split in
  order, a corrupted shard on every rank, the ``last_good`` fallback, a leftover
  ``.tmp``, a version mismatch, an incomplete set, a custom fold failing loud, and a
  collection round trip. Each port restore is held to the JAX restore of the same
  states (integers exactly, floats to 1e-6), with JAX in 32-bit mode, the port's
  dtypes.
- A port shard's array keys equal the JAX shard's; a JAX-written shard set restores
  into the port (and a port-written one into JAX) to the same values.
- The continuous snapshots of ``tests/test_txn.py``: the last-good chain, pruning, and
  a SIGTERM to a child process that flushes a final shard which ``restore_latest``
  resumes from; the cadence knob parses alike in both packages.
- A shard written while the port's scan queue holds steps (or while an update is in
  flight, for the signal-time flush) holds the drained state.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu as jtm
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.parallel.elastic as jel
import torchmetrics_tpu_torch as ttm
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.parallel.elastic as tel
from torchmetrics_tpu.metric import Metric as JaxMetric
from torchmetrics_tpu.utilities.exceptions import TorchMetricsUserError as JaxUserError
from torchmetrics_tpu_torch import Metric as TorchMetric
from torchmetrics_tpu_torch.diag import diag_context
from torchmetrics_tpu_torch.engine import engine_context
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "port")


def _el(side):
    return jel if side == "jax" else tel


def _arr(side, x):
    return jnp.asarray(x) if side == "jax" else torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _acc(side):
    pkg = jc if side == "jax" else tc
    kw = {} if side == "jax" else {"device": "cpu"}
    return pkg.MulticlassAccuracy(num_classes=3, average="micro", **kw)


def _rank_batch(rank, rows=6):
    return (
        np.random.RandomState(rank).rand(rows, 3).astype(np.float32),
        np.random.RandomState(100 + rank).randint(0, 3, rows).astype(np.int32),
    )


def _states(m) -> dict:
    out = {}
    for attr in m._defaults:
        v = getattr(m, attr)
        out[attr] = [_np(x) for x in v] if isinstance(v, list) else _np(v)
    out["_update_count"] = m._update_count
    return out


def _assert_same(got, want) -> None:
    assert type(got) is type(want) or isinstance(got, (np.ndarray, np.generic)), (got, want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _two_rank_shards(side, directory, make=_acc, update=None, name="ck"):
    """A world-2 run: two ranks with different batches, each saving its shard."""
    update = update or (lambda m, rank: m.update(*(_arr(side, x) for x in _rank_batch(rank))))
    base = str(directory / name)
    metrics = []
    for rank in range(2):
        m = make(side)
        update(m, rank)
        _el(side).save_state_shard(m, _el(side).shard_path(base, rank, 2), rank=rank, world_size=2)
        metrics.append(m)
    return metrics


def _restore_all(side, directory, world, make=_acc, **kw):
    out = []
    for rank in range(world):
        m = make(side)
        _el(side).restore_resharded(m, str(directory), rank=rank, world_size=world, **kw)
        out.append(m)
    return out


@pytest.fixture()
def jax32():
    with jax.enable_x64(False):
        yield


# ------------------------------------------------------------------ reshard


@pytest.mark.parametrize("world", [1, 2, 3])
def test_reshard_matches_jax(tmp_path, jax32, world):
    restored = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d)
        restored[side] = _restore_all(side, d, world)
    for j, t in zip(restored["jax"], restored["port"]):
        _assert_same(_states(t), _states(j))
        _assert_same(_np(t.compute()), _np(j.compute()))
    # the restored world, folded with merge_state, equals the 2-rank fold
    sources = _two_rank_shards("port", tmp_path / "port", name="again")
    want = sources[0]
    want.merge_state(sources[1])
    got = restored["port"][0]
    for other in restored["port"][1:]:
        got.merge_state(other)
    _assert_same(_states(got), _states(want))
    assert float(got.compute()) == float(want.compute())


def test_reshard_cat_lists_split_in_order(tmp_path, jax32):
    def make(side):
        return (jtm if side == "jax" else ttm).CatMetric(**({} if side == "jax" else {"device": "cpu"}))

    chunks = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d, make=make, update=lambda m, r, s=side: m.update(_arr(s, np.arange(3.0, dtype=np.float32) + 10 * r)))
        restored = _restore_all(side, d, 3, make=make)
        chunks[side] = [np.concatenate([_np(v) for v in m.value]) if m.value else np.zeros((0,), np.float32) for m in restored]
    _assert_same(chunks["port"], chunks["jax"])
    np.testing.assert_array_equal(np.concatenate(chunks["port"]), np.r_[np.arange(3.0), np.arange(3.0) + 10])


def _tamper(path, fn):
    flat = dict(np.load(path, allow_pickle=False))
    fn(flat)
    with open(path, "wb") as fh:
        np.savez(fh, **flat)


def _bump_first_payload(flat, by=1):
    key = next(k for k in sorted(flat) if not k.startswith("__"))
    flat[key] = np.asarray(flat[key]) + by


def test_corrupted_shard_fails_loud_on_every_rank(tmp_path, jax32):
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d)
        _tamper(str(d / _el(side).shard_path("ck", 0, 2)), _bump_first_payload)
        for rank in range(2):
            with pytest.raises(_el(side).SnapshotIntegrityError, match="integrity check"):
                _el(side).restore_resharded(_acc(side), str(d), rank=rank, world_size=2)


def test_corrupted_shard_falls_back_to_last_good(tmp_path, jax32):
    got = {}
    for side in SIDES:
        good, bad = tmp_path / side / "good", tmp_path / side / "bad"
        good.mkdir(parents=True)
        bad.mkdir()
        _two_rank_shards(side, good)
        _two_rank_shards(side, bad)
        _tamper(str(bad / _el(side).shard_path("ck", 1, 2)), lambda f: _bump_first_payload(f, 7))
        m = _acc(side)
        if side == "port":
            with diag_context() as rec:
                _el(side).restore_resharded(m, str(bad), rank=0, world_size=1, last_good=str(good))
            assert rec.count("snapshot.fallback") == 1 and rec.count("snapshot.restore") == 1
        else:
            _el(side).restore_resharded(m, str(bad), rank=0, world_size=1, last_good=str(good))
        got[side] = (_states(m), float(m.compute()))
    _assert_same(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]


def test_leftover_tmp_is_ignored(tmp_path, jax32):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d)
        (d / "ck.rank0-of-2.npz.tmp").write_bytes(b"PARTIAL WRITE GARBAGE")
        (m,) = _restore_all(side, d, 1)
        got[side] = _states(m)
    _assert_same(got["port"], got["jax"])


def test_version_mismatch_fails_loud_on_every_rank(tmp_path, jax32):
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d)

        def restamp(flat, side=side):
            flat["__elastic_version__"] = np.asarray(_el(side).SNAPSHOT_VERSION + 1)
            flat["__crc__"] = np.asarray(_el(side)._payload_crc(flat), dtype=np.uint32)

        _tamper(str(d / _el(side).shard_path("ck", 0, 2)), restamp)
        for rank in range(2):
            with pytest.raises(_el(side).SnapshotVersionError, match="layout version"):
                _el(side).restore_resharded(_acc(side), str(d), rank=rank, world_size=2)


def test_incomplete_shard_set_fails_loud(tmp_path, jax32):
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d)
        os.remove(str(d / _el(side).shard_path("ck", 1, 2)))
        with pytest.raises(_el(side).SnapshotIntegrityError, match="incomplete"):
            _el(side).restore_resharded(_acc(side), str(d), rank=0, world_size=1)


class JaxProd(JaxMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("prod", jnp.ones((), dtype=jnp.float32), dist_reduce_fx=lambda s: jnp.prod(s, axis=0))

    def update(self, x):
        self.prod = self.prod * x

    def compute(self):
        return self.prod


class TorchProd(TorchMetric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("prod", torch.ones((), dtype=torch.float32), dist_reduce_fx=lambda s: torch.prod(s, dim=0))

    def update(self, x):
        self.prod = self.prod * x

    def compute(self):
        return self.prod


def test_custom_fold_restores_same_world_and_fails_loud_otherwise(tmp_path, jax32):
    def make(side):
        return JaxProd() if side == "jax" else TorchProd()

    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d, make=make, update=lambda m, r, s=side: m.update(_arr(s, np.float32(2.0 + r))))
        same = make(side)
        _el(side).restore_resharded(same, str(d), rank=0, world_size=2)
        assert float(same.prod) == 2.0
        with pytest.raises(_el(side).SnapshotReshardError, match="custom"):
            _el(side).restore_resharded(make(side), str(d), rank=0, world_size=1)


def _collection(side):
    pkg, cls = (jtm, jc) if side == "jax" else (ttm, tc)
    kw = {} if side == "jax" else {"device": "cpu"}
    return pkg.MetricCollection({"acc": cls.MulticlassAccuracy(num_classes=3, average="micro", **kw), "mean": pkg.MeanMetric(**kw)})


def _collection_update(side):
    def update(coll, rank):
        coll["acc"].update(_arr(side, np.random.RandomState(rank).rand(4, 3).astype(np.float32)), _arr(side, np.asarray([0, 1, 2, 1], np.int32)))
        coll["mean"].update(_arr(side, np.float32(rank + 2)))

    return update


@pytest.mark.parametrize("world", [1, 3])
def test_collection_reshard_matches_jax(tmp_path, jax32, world):
    got = {}
    for side in SIDES:
        d = tmp_path / side
        d.mkdir()
        _two_rank_shards(side, d, make=_collection, update=_collection_update(side))
        restored = _restore_all(side, d, world, make=_collection)
        got[side] = [({k: _np(v) for k, v in c.compute().items()}, {n: _states(m) for n, m in c.items(keep_base=True)}) for c in restored]
    _assert_same(got["port"], got["jax"])
    if world == 1:
        assert float(got["port"][0][0]["mean"]) == 2.5


# ------------------------------------------------------------------ across packages


def test_shard_keys_equal_jax_keys(tmp_path, jax32):
    keys = {}
    for side in SIDES:
        for make, update, name in (
            (_acc, None, "acc"),
            (_collection, _collection_update(side), "coll"),
        ):
            d = tmp_path / side / name
            d.mkdir(parents=True)
            _two_rank_shards(side, d, make=make, update=update)
            with np.load(d / "ck.rank0-of-2.npz") as npz:
                keys[(side, name)] = sorted(npz.files)
    assert keys[("port", "acc")] == keys[("jax", "acc")]
    assert keys[("port", "coll")] == keys[("jax", "coll")]
    assert "__crc__" in keys[("port", "acc")] and "_update_count" in keys[("port", "acc")]


@pytest.mark.parametrize("x64", [False, True], ids=["jax32", "jax64"])
def test_jax_written_shards_restore_into_the_port(tmp_path, x64):
    with jax.enable_x64(x64):
        _two_rank_shards("jax", tmp_path)
        want = [_states(m) for m in _restore_all("jax", tmp_path, 3)]
    got = [_states(m) for m in _restore_all("port", tmp_path, 3)]
    for g, w in zip(got, want):
        for k in w:
            if k != "_update_count":
                assert g[k].dtype == np.int32, (k, g[k].dtype)  # the port's counters
        _assert_same(g, {k: v if k == "_update_count" else np.asarray(v).astype(g[k].dtype) for k, v in w.items()})


def _mse(side):
    if side == "jax":
        return jtm.MeanSquaredError()
    return ttm.MeanSquaredError(device="cpu")


def _mse_update(side):
    def update(m, rank):
        rng = np.random.RandomState(40 + rank)
        m.update(_arr(side, rng.rand(7).astype(np.float32)), _arr(side, rng.rand(7).astype(np.float32)))

    return update


@pytest.mark.parametrize("x64", [False, True], ids=["jax32", "jax64"])
def test_jax_written_float_states_restore_into_the_port(tmp_path, x64):
    """Float sums written by JAX (float64 in 64-bit mode) restore at the port's
    registered dtypes, to the JAX values."""
    with jax.enable_x64(x64):
        _two_rank_shards("jax", tmp_path, make=_mse, update=_mse_update("jax"))
        want = [_states(m) for m in _restore_all("jax", tmp_path, 3, make=_mse)]
    got = [_states(m) for m in _restore_all("port", tmp_path, 3, make=_mse)]
    defaults = {k: v.dtype for k, v in _mse("port")._defaults.items()}
    for g, w in zip(got, want):
        for k, dtype in defaults.items():
            assert torch.from_numpy(np.asarray(g[k])).dtype == dtype, (k, g[k].dtype, dtype)
        _assert_same(g, {k: v if k == "_update_count" else np.asarray(v).astype(g[k].dtype) for k, v in w.items()})
    ported = _mse("port")
    tel.restore_resharded(ported, str(tmp_path), rank=0, world_size=1)
    ported.update(torch.ones(3), torch.zeros(3))
    assert ported.compute().dtype == torch.float32


def test_float_state_overflow_is_refused(tmp_path, jax32):
    m = _mse("port")
    m.update(torch.ones(2), torch.zeros(2))
    path = tel.shard_path(str(tmp_path / "ck"), 0, 1)
    tel.save_state_shard(m, path, rank=0, world_size=1)
    with np.load(path) as f:
        arrays = dict(f)
    arrays["sum_squared_error"] = np.asarray(1e300, dtype=np.float64)
    arrays["__crc__"] = np.asarray(tel._payload_crc(arrays), dtype=np.uint32)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises(tel.SnapshotIntegrityError, match="overflow"):
        tel.restore_resharded(_mse("port"), str(tmp_path), rank=0, world_size=1)


def test_port_written_shards_restore_into_jax(tmp_path, jax32):
    _two_rank_shards("port", tmp_path)
    want = [_states(m) for m in _restore_all("port", tmp_path, 1)]
    got = [_states(m) for m in _restore_all("jax", tmp_path, 1)]
    _assert_same(got, want)


# ------------------------------------------------------------------ continuous snapshots


def _stream(n, seed=15):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.rand(8, 5).astype(np.float32)), torch.from_numpy(rng.randint(0, 5, 8))) for _ in range(n)]


def _acc5(**kw):
    return ttm.MulticlassAccuracy(5, validate_args=False, device="cpu", **kw)


def test_snapshot_policy_env_parses_alike(monkeypatch):
    for raw in ("500", "30s", "2.5s", " 12 ", "bogus", "30sec", "0", "-5", "0s", ""):
        monkeypatch.setenv(tel.SNAPSHOT_EVERY_ENV_VAR, raw)
        seen = {}
        for side in SIDES:
            try:
                p = _el(side).SnapshotPolicy.from_env()
                seen[side] = None if p is None else (p.every_updates, p.every_seconds)
            except Exception as err:  # noqa: BLE001 -- both must fail alike
                seen[side] = ("raises", isinstance(err, (TorchMetricsUserError, JaxUserError)))
        assert seen["jax"] == seen["port"], (raw, seen)


def test_restore_latest_walks_last_good_chain(tmp_path):
    (p, t), (p2, t2) = _stream(2)
    m = _acc5()
    m.update(p, t)
    good_fp = tel.state_fingerprint(m)
    for rank in range(2):
        tel.save_state_shard(m, tel.shard_path(str(tmp_path / "snap-000001"), rank, 2), rank=rank, world_size=2)
    m.update(p2, t2)  # seq 2: a preemption caught only rank 1
    tel.save_state_shard(m, tel.shard_path(str(tmp_path / "snap-000002"), 1, 2), rank=1, world_size=2)
    fresh = _acc5()
    with diag_context() as rec:
        assert tel.restore_latest(fresh, str(tmp_path), rank=0, world_size=2) == 1
    assert tel.state_fingerprint(fresh) == good_fp
    assert [e.kind for e in rec.snapshot() if e.kind.startswith("snapshot.")] == [
        "snapshot.fallback", "snapshot.restore", "snapshot.restore_latest"
    ]
    for path in list(tmp_path.iterdir()):
        path.write_bytes(b"corrupt")
    with pytest.raises(tel.SnapshotIntegrityError):
        tel.restore_latest(_acc5(), str(tmp_path), rank=0, world_size=2)


def test_snapshot_prune_keeps_complete_recent_sequences(tmp_path):
    (p, t), = _stream(1)
    m = _acc5()
    snap = tel.ContinuousSnapshotter(m, str(tmp_path), policy=None, keep=2)
    for _ in range(4):
        m.update(p, t)
        snap.flush()
    assert [seq for seq, _ in tel.list_snapshots(str(tmp_path))] == [3, 4]
    fresh = _acc5()
    assert tel.restore_latest(fresh, str(tmp_path)) == 4
    assert tel.state_fingerprint(fresh) == tel.state_fingerprint(m)


def test_cadence_counts_from_the_last_flush(tmp_path):
    clock = [0.0]
    m = _acc5()
    snap = tel.ContinuousSnapshotter(m, str(tmp_path), policy=tel.SnapshotPolicy(every_updates=3), clock=lambda: clock[0])
    flushed = []
    for p, t in _stream(7):
        m.update(p, t)
        flushed.append(snap.note_update() is not None)
    assert flushed == [False, False, True, False, False, True, False] and snap.seq == 2
    timed = tel.ContinuousSnapshotter(m, str(tmp_path / "t"), policy=tel.SnapshotPolicy(every_seconds=2.5), clock=lambda: clock[0])
    assert timed.note_update() is None
    clock[0] = 2.6
    assert timed.note_update() is not None


_SIGTERM_CHILD = r"""
import json, os, signal, sys, time
sys.path.insert(0, sys.argv[2])
import numpy as np
import torch
from torchmetrics_tpu_torch import MulticlassAccuracy
from torchmetrics_tpu_torch.parallel.elastic import ContinuousSnapshotter, SnapshotPolicy, state_fingerprint

out_dir = sys.argv[1]
m = MulticlassAccuracy(5, validate_args=False, device="cpu")
fps = {}

def note():
    if snap.seq and str(snap.seq) not in fps:
        fps[str(snap.seq)] = [state_fingerprint(m), m.update_count]

def record_fp(signum, frame):
    # runs after the snapshotter's flush, which chains to it
    note()
    with open(os.path.join(out_dir, "fp.json"), "w") as fh:
        json.dump(fps, fh)
    signal.signal(signum, signal.SIG_DFL)
    signal.raise_signal(signum)

signal.signal(signal.SIGTERM, record_fp)
snap = ContinuousSnapshotter(m, out_dir, policy=SnapshotPolicy(every_updates=3))
snap.install_signal_handlers(signals=(signal.SIGTERM,))
rng = np.random.RandomState(0)
print("ready", flush=True)
while True:
    m.update(torch.from_numpy(rng.rand(8, 5).astype(np.float32)), torch.from_numpy(rng.randint(0, 5, 8)))
    snap.note_update()
    note()
    time.sleep(0.01)
"""


def test_sigterm_flushes_a_final_shard_and_restore_latest_resumes(tmp_path):
    child = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_CHILD, str(tmp_path), ROOT], stdout=subprocess.PIPE, text=True
    )
    try:
        assert child.stdout.readline().strip() == "ready"
        deadline = time.time() + 60.0
        while time.time() < deadline and not tel.list_snapshots(str(tmp_path)):
            time.sleep(0.05)
        assert tel.list_snapshots(str(tmp_path)), "the child never reached its first cadence flush"
        time.sleep(0.1)
        child.terminate()
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert rc == -signal.SIGTERM
    with open(tmp_path / "fp.json") as fh:
        dying = json.load(fh)
    fresh = _acc5()
    seq = tel.restore_latest(fresh, str(tmp_path))
    assert seq == max(s for s, _ in tel.list_snapshots(str(tmp_path)))
    fp, count = dying[str(seq)]
    assert tel.state_fingerprint(fresh) == fp and fresh.update_count == count
    # resume: the restored metric keeps accumulating like the uninterrupted stream
    rng = np.random.RandomState(0)
    stream = [(torch.from_numpy(rng.rand(8, 5).astype(np.float32)), torch.from_numpy(rng.randint(0, 5, 8))) for _ in range(count + 3)]
    whole = _acc5()
    for p, t in stream:
        whole.update(p, t)
    for p, t in stream[count:]:
        fresh.update(p, t)
    assert torch.equal(fresh.tp, whole.tp) and float(fresh.compute()) == float(whole.compute())


def test_flush_during_the_scan_queue_holds_the_drained_state(tmp_path):
    batches = _stream(6)
    eager = _acc5(compiled_update=False)
    for p, t in batches:
        eager.update(p, t)
    with engine_context(True):
        queued = _acc5(scan_steps=4)
        snap = tel.ContinuousSnapshotter(queued, str(tmp_path), policy=None)
        for p, t in batches:
            queued.update(p, t)
        assert queued._engine._scan.pending  # 2 steps still queued
        snap.preempt_flush(signal.SIGTERM)
        assert not queued._engine._scan.pending
    fresh = _acc5()
    assert tel.restore_latest(fresh, str(tmp_path)) == 1
    for attr in eager._defaults:
        assert torch.equal(getattr(fresh, attr), getattr(eager, attr)), attr
    assert fresh.update_count == 6


def test_preempt_flush_stands_on_the_last_snapshot_mid_update(tmp_path):
    (p, t), = _stream(1)
    mc = ttm.MetricCollection({"acc": _acc5(), "cm": ttm.MulticlassConfusionMatrix(5, validate_args=False, device="cpu")})
    mc.update(p, t)
    snap = tel.ContinuousSnapshotter(mc, str(tmp_path), policy=None)
    snap.flush()
    seen = []
    real_update = mc._modules["acc"]._raw_update

    def update_then_signal(*args, **kwargs):
        real_update(*args, **kwargs)
        seen.append(snap.preempt_flush(signal.SIGTERM))  # as a handler landing inside the update

    mc._modules["acc"]._raw_update = update_then_signal
    with diag_context() as rec, engine_context(False):
        mc._modules["acc"].update(p, t)
    assert seen == [None] and snap.seq == 1
    assert [e.data.get("skipped") for e in rec.snapshot() if e.kind == "snapshot.preempt"] == ["mid-update"]
    assert snap.preempt_flush(signal.SIGTERM) is not None and snap.seq == 2
