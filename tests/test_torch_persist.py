"""The signature manifest, prewarm and the warm-replica handoff of the port
(``torchmetrics_tpu_torch/engine/persist.py``), held against the JAX package's
``engine/persist.py``.

The JAX side runs what runs on the CPU: its env parser, ``record_compile`` /
``load_manifest`` and its engines' manifest rows, with its executable store and load
stubbed to a miss (a round trip of a persisted executable on the 8-device CPU backend
fails in ``execute_sharded``, as ``tests/test_persist.py`` shows). The port: the same rows from the same calls, a JAX-written
manifest prewarmed in the port, the counted misses and typed rejections, prewarm's value
inertness (held static buffers, riders, ``_update_count``, no copies into the buffers at
the next update), scan and fused rows, ``warm_start`` against ``restore_latest`` and the
sidecar's handoff before it serves.
"""

from __future__ import annotations

import json
import os
import pickle
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.engine.persist as jpersist
import torchmetrics_tpu_torch as tm
import torchmetrics_tpu_torch.engine.persist as persist
from torchmetrics_tpu_torch.engine import engine_context, persist_context, scan_context

C = 5


def _np_stream(sizes=(20, 32, 20), seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, C).astype(np.float32), rng.randint(0, C, n).astype(np.int32)) for n in sizes]


def _stream(sizes=(20, 32, 20), seed=3):
    return [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in _np_stream(sizes, seed)]


def _acc():
    return tm.MulticlassAccuracy(C, average="macro", validate_args=False, device="cpu")


def _pair():
    return tm.MetricCollection({
        "acc": tm.MulticlassAccuracy(C, average="macro", validate_args=False, device="cpu"),
        "cm": tm.MulticlassConfusionMatrix(C, validate_args=False, device="cpu"),
    })


def _states(m) -> dict:
    return {k: getattr(m, k).clone() for k in m._defaults}


def _assert_states_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ the surface


def test_the_module_exports_every_jax_name():
    assert set(jpersist.__all__) <= set(persist.__all__)
    assert set(persist.__all__) - set(jpersist.__all__) == {"try_load_executable"}
    for name in persist.__all__:
        assert hasattr(persist, name), name


def test_the_engine_package_exports_the_jax_persist_names():
    import torchmetrics_tpu.engine as jengine
    import torchmetrics_tpu_torch.engine as tengine

    names = {n for n in jengine.__all__ if hasattr(jpersist, n)}
    assert names == {"PersistEnvelopeError", "PersistIntegrityError", "persist_context", "persist_state",
                     "prewarm", "set_persist_dir", "warm_start"}
    for n in names:
        assert getattr(tengine, n) is getattr(persist, n)
        assert n in tengine.__all__


@pytest.mark.parametrize("raw", [None, "0", "off", "OFF", "/some/cache/dir", " /padded/dir ", "", "   "])
def test_env_contract_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(persist.PERSIST_ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(persist.PERSIST_ENV_VAR, raw)
    results = []
    for mod in (persist, jpersist):
        try:
            results.append(("ok", mod.persist_dir()))
        except Exception as err:  # noqa: BLE001 -- the kind and message are compared
            results.append((type(err).__name__, str(err)))
    assert results[0] == results[1]


def test_the_knob_is_registered_and_the_overrides_nest(monkeypatch, tmp_path):
    import importlib

    from torchmetrics_tpu_torch.engine.config import KNOB_REGISTRY

    module, attr = KNOB_REGISTRY[persist.PERSIST_ENV_VAR].split(":")
    assert getattr(importlib.import_module(module), attr) is persist.persist_dir
    monkeypatch.setenv(persist.PERSIST_ENV_VAR, str(tmp_path / "env"))
    with persist_context(str(tmp_path / "a")):
        assert persist.persist_dir() == str(tmp_path / "a")
        with persist_context(None):
            assert persist.persist_dir() is None
        assert persist.persist_dir() == str(tmp_path / "a")
    assert persist.persist_dir() == str(tmp_path / "env")
    persist.set_persist_dir(str(tmp_path / "b"))
    try:
        assert persist.persist_dir() == str(tmp_path / "b")
    finally:
        persist._dir_override = persist._UNSET


def test_persist_state_has_the_jax_keys():
    assert set(persist.persist_state()) == set(jpersist.persist_state())
    assert persist.persist_state()["native_fallback"] is False


def test_the_envelope_keys_are_the_jax_ones_with_torch_for_jax():
    theirs = set(jpersist.compat_envelope())
    ours = set(persist.compat_envelope("cpu"))
    assert ours == (theirs - {"jax", "jaxlib", "x64"}) | {"torch", "cuda"}
    env = persist.compat_envelope("cpu")
    assert (env["backend"], env["device_kind"], env["device_count"], env["mesh"]) == ("cpu", "cpu", 1, "")


# ------------------------------------------------------------------ the manifest


def _record_calls(mod, arrays):
    p, t, mask, half = arrays
    mod.record_compile("MulticlassAccuracy", "update", args=[p, t], bucket=32)
    mod.record_compile("epoch:MulticlassAccuracy", "compute")
    mod.record_compile("MulticlassAccuracy", "scan", args=[p, t], k=8)
    mod.record_compile("fused:MulticlassAccuracy,MulticlassConfusionMatrix", "fused", args=[p, t], bucket=32)
    mod.record_compile("BinaryAccuracy", "update", args=[p], kw={"target": t, "mask": mask}, bucket=None)
    mod.record_compile("SumMetric", "update", args=[half, 3])
    mod.record_compile("epoch:collection[acc,cm]", "sync-compute")
    mod.record_compile("MulticlassAccuracy", "update", args=[p, t], bucket=32)  # a duplicate: deduped


def test_record_compile_rows_are_identical_in_both_packages(tmp_path):
    p, t = _np_stream()[1]
    mask = np.ones(32, dtype=bool)
    half = np.zeros((4, 2), dtype=np.float16)
    with jpersist.persist_context(str(tmp_path / "jax")):
        _record_calls(jpersist, (jnp.asarray(p), jnp.asarray(t), jnp.asarray(mask), jnp.asarray(half)))
    with persist_context(str(tmp_path / "torch")):
        _record_calls(persist, tuple(torch.from_numpy(a) for a in (p, t, mask, half)))
    ours = (tmp_path / "torch" / "manifest.jsonl").read_bytes()
    assert ours == (tmp_path / "jax" / "manifest.jsonl").read_bytes()
    rows = persist.load_manifest(str(tmp_path / "torch"))
    assert len(rows) == 7
    assert rows[0]["args"] == [[[32, C], "float32"], [[32], "int32"]]
    assert rows[5]["args"] == [[[4, 2], "float16"], [[], "int"]]
    assert [r["sig"] for r in rows] == [r["sig"] for r in jpersist.load_manifest(str(tmp_path / "jax"))]


def test_dedup_is_seeded_from_disk_and_a_corrupt_line_is_skipped_and_counted(tmp_path):
    from torchmetrics_tpu_torch.diag import diag_context

    d = str(tmp_path)
    p, t = _stream()[1]
    with persist_context(d):
        persist.record_compile("MulticlassAccuracy", "update", args=[p, t], bucket=32)
        with open(os.path.join(d, "manifest.jsonl"), "a") as fh:
            fh.write("{not json\n")
            fh.write('["a list"]\n')
        persist._MANIFEST_SEEN.pop(d)  # a restarted process: the dedup set is seeded from the file
        persist.record_compile("MulticlassAccuracy", "update", args=[p, t], bucket=32)
        persist.record_compile("epoch:MulticlassAccuracy", "compute")
        before = persist.persist_state()
        with diag_context(capacity=64) as rec:
            rows = persist.load_manifest()
        after = persist.persist_state()
    assert [r["kind"] for r in rows] == ["update", "compute"]
    assert after["corrupt_skips"] - before["corrupt_skips"] == 2
    assert rec.count("persist.fallback") == 2


def test_record_compile_is_a_noop_with_persistence_off(tmp_path, monkeypatch):
    monkeypatch.delenv(persist.PERSIST_ENV_VAR, raising=False)
    persist.record_compile("MulticlassAccuracy", "update", args=[torch.zeros(3)], bucket=8)
    assert not os.listdir(tmp_path)


def _jax_engine_rows(tmp_path, monkeypatch) -> list:
    """The rows the JAX engines write for MulticlassAccuracy(5) over the stream: one
    metric, one under a K=4 scan, a collection with a confusion matrix (fused), their
    computes. Its executable store and load are stubbed to a miss."""
    from torchmetrics_tpu.classification import MulticlassAccuracy as JAcc, MulticlassConfusionMatrix as JCM
    from torchmetrics_tpu.collections import MetricCollection as JMC
    from torchmetrics_tpu.engine import engine_context as j_engine, scan_context as j_scan

    monkeypatch.setattr(jpersist, "store_executable", lambda *a, **k: False)
    monkeypatch.setattr(jpersist, "try_load_executable", lambda *a, **k: None)
    stream = [(jnp.asarray(p), jnp.asarray(t)) for p, t in _np_stream()]
    d = str(tmp_path / "jax")
    with jpersist.persist_context(d), j_engine(True, donate=True):
        m = JAcc(C, average="macro", validate_args=False)
        for p, t in stream:
            m.update(p, t)
        m.compute()
        with j_scan(4):
            s = JAcc(C, average="macro", validate_args=False)
            for p, t in stream:
                s.update(p, t)
            s.compute()
        mc = JMC({"acc": JAcc(C, average="macro", validate_args=False), "cm": JCM(C, validate_args=False)})
        for p, t in stream:
            mc.update(p, t)
        mc.compute()
    return jpersist.load_manifest(d)


def _torch_engine_rows(tmp_path) -> list:
    d = str(tmp_path / "torch")
    with persist_context(d), engine_context(True):
        m = _acc()
        for p, t in _stream():
            m.update(p, t)
        m.compute()
        with scan_context(4):
            s = _acc()
            for p, t in _stream():
                s.update(p, t)
            s.compute()
        mc = _pair()
        for p, t in _stream():
            mc.update(p, t)
        mc.compute()
    return persist.load_manifest(d)


def test_the_engines_write_the_jax_rows(tmp_path, monkeypatch):
    """Owner, kind, bucket and k agree row for row. Kept divergence: an update or fused
    row carries the caller's rows (20 here) where the JAX engine records them padded to
    the bucket (32); both replay into the bucket's graph."""
    key = lambda r: (r["owner"], r["kind"], r["bucket"], r["k"])  # noqa: E731
    ours, theirs = _torch_engine_rows(tmp_path), _jax_engine_rows(tmp_path, monkeypatch)
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    assert {r["kind"] for r in ours} == {"update", "scan", "fused", "compute"}
    by_key = {key(r): r for r in theirs}
    for row in ours:
        want = by_key[key(row)]["args"]
        got = row["args"]
        if row["kind"] in ("update", "fused"):
            assert [shape[0] for shape, _ in got] == [20, 20]
            got = [[[row["bucket"], *shape[1:]], dtype] for shape, dtype in got]
        assert got == want, row


def test_a_jax_written_manifest_prewarms_the_port(tmp_path):
    d = str(tmp_path)
    p, t = _np_stream()[1]
    with jpersist.persist_context(d):
        jpersist.record_compile("MulticlassAccuracy", "update", args=[jnp.asarray(p), jnp.asarray(t)], bucket=32)
        jpersist.record_compile("epoch:MulticlassAccuracy", "compute")
    with engine_context(True):
        warm = _acc()
        report = persist.prewarm(warm, directory=d)
        assert (report["entries"], report["replayed"], report["skipped"], report["failed"]) == (2, 2, 0, 0)
        assert (warm._engine.stats.traces, warm._epoch.stats.compute_traces) == (1, 1)
        cold = _acc()
        for m in (warm, cold):
            for p_, t_ in _stream():
                m.update(p_, t_)
        assert warm._engine.stats.traces == 1  # the 20- and 32-row batches replay the prewarmed bucket
        assert torch.equal(warm.compute(), cold.compute())
        assert warm._epoch.stats.compute_traces == 1
    _assert_states_equal(_states(warm), _states(cold))


# ------------------------------------------------------------------ the executable cache


def _plant(tmp_path, payload: bytes, envelope=None, crc=None, fmt=1, raw=None) -> str:
    path = persist._artifact_path(str(tmp_path), "MulticlassAccuracy", "update", "abc", "cpu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    record = {
        "format": fmt, "envelope": envelope if envelope is not None else persist.compat_envelope("cpu"),
        "owner": "MulticlassAccuracy", "kind": "update", "signature": "abc", "payload": payload,
        "crc": zlib.crc32(payload) & 0xFFFFFFFF if crc is None else crc,
    }
    with open(path, "wb") as fh:
        fh.write(raw if raw is not None else pickle.dumps(record))
    return path


@pytest.mark.parametrize(
    "case, error, counter",
    [
        ("stale-envelope", persist.PersistEnvelopeError, "envelope_rejects"),
        ("old-format", persist.PersistEnvelopeError, "envelope_rejects"),
        ("bad-crc", persist.PersistIntegrityError, "corrupt_skips"),
        ("not-a-pickle", persist.PersistIntegrityError, "corrupt_skips"),
        ("valid", None, None),
    ],
)
def test_an_artifact_is_checked_as_jax_does_and_every_lookup_is_a_counted_miss(tmp_path, case, error, counter):
    from torchmetrics_tpu_torch.diag import diag_context

    stale = dict(persist.compat_envelope("cpu"), torch="0.0.0")
    kwargs = {
        "stale-envelope": {"envelope": stale}, "old-format": {"fmt": 0}, "bad-crc": {"crc": 1},
        "not-a-pickle": {"raw": b"\x00truncated"}, "valid": {},
    }[case]
    _plant(tmp_path, b"graph-bytes", **kwargs)
    with persist_context(str(tmp_path)):
        if error is None:
            assert persist.load_executable("MulticlassAccuracy", "update", "abc", "cpu") is None
        else:
            with pytest.raises(error):
                persist.load_executable("MulticlassAccuracy", "update", "abc", "cpu")
        before = persist.persist_state()
        with diag_context(capacity=16) as rec:
            assert persist.try_load_executable("MulticlassAccuracy", "update", "abc", "cpu") is None
        after = persist.persist_state()
    assert after["misses"] - before["misses"] == 1 and after["hits"] == before["hits"]
    if counter is not None:
        assert after[counter] - before[counter] == 1
    assert rec.count("persist.fallback") == (0 if error is None else 1)


def test_store_executable_stores_nothing_and_each_build_is_a_counted_miss(tmp_path):
    with persist_context(str(tmp_path)):
        assert persist.store_executable("MulticlassAccuracy", "update", "abc", object()) is False
        assert not os.path.exists(os.path.join(str(tmp_path), "executables"))
        before = persist.persist_state()
        with engine_context(True):
            m = _acc()
            for p, t in _stream():
                m.update(p, t)
            m.compute()
        after = persist.persist_state()
    assert m._engine.stats.persist_misses == 1 and m._engine.stats.persist_hits == 0
    assert m._epoch.stats.persist_misses == 1
    assert after["misses"] - before["misses"] == 2 and after["stores"] == before["stores"]
    with engine_context(True):  # persistence off: no lookup
        off = _acc()
        off.update(*_stream()[0])
    assert off._engine.stats.persist_misses == 0


# ------------------------------------------------------------------ prewarm


def _seeded_manifest(d: str, scan: bool = False) -> None:
    """A donor run that writes the manifest: update + compute (or the K=4 scan)."""
    with persist_context(d), engine_context(True), (scan_context(4) if scan else _null()):
        donor = _acc()
        for p, t in _stream():
            donor.update(p, t)
        donor.compute()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *_):
        return False


def test_prewarm_is_value_inert_on_a_live_metric_with_riders(tmp_path):
    from torchmetrics_tpu_torch.diag import sentinel_context
    from torchmetrics_tpu_torch.engine import quarantine_context

    d = str(tmp_path)
    _seeded_manifest(d)
    with sentinel_context(True), quarantine_context(True), engine_context(True):
        live, twin = _acc(), _acc()
        for m in (live, twin):
            for p, t in _stream()[:2]:
                m.update(p, t)
        held = live.tp
        assert getattr(held, "_engine_static", False)
        before = _states(live)
        riders = {a: live.__dict__[a].clone() for a in ("_sentinel_flags", "_quarantined_count")}
        count, traces = live._update_count, live._engine.stats.traces
        report = persist.prewarm(live, directory=d)
        assert report["failed"] == 0 and report["replayed"] == 2
        assert live.tp is held
        _assert_states_equal(_states(live), before)
        for a, v in riders.items():
            assert torch.equal(live.__dict__[a], v), a
        assert live._update_count == count and live._computed is None
        copies = live._engine.stats.donation_copies
        for m in (live, twin):
            m.update(*_stream()[2])
        assert live._engine.stats.donation_copies == copies
        assert live._engine.stats.traces == traces  # the replays and the update ride the live graph
        _assert_states_equal(_states(live), _states(twin))
        assert torch.equal(live.compute(), twin.compute())


def test_prewarm_of_a_fresh_metric_leaves_its_first_update_a_replay(tmp_path):
    from torchmetrics_tpu_torch.diag import diag_context, transfer_guard

    d = str(tmp_path)
    _seeded_manifest(d)
    with engine_context(True):
        warm, cold = _acc(), _acc()
        with diag_context(capacity=256) as rec, transfer_guard("strict"):
            report = persist.prewarm(warm, directory=d)
        assert rec.count("transfer.host", "transfer.blocked") == 0
        assert rec.count("persist.prewarm") == 1
        assert report["misses"] == 2 and report["hits"] == 0
        assert warm._update_count == 0 and warm._state_fresh
        assert warm._engine.stats.prewarm_replays == 2
        st = warm._engine.stats
        traces, copies = st.traces, st.donation_copies
        for m in (warm, cold):
            for p, t in _stream():
                m.update(p, t)
        assert (st.traces, st.donation_copies, st.cache_hits) == (traces, copies, 3)
        _assert_states_equal(_states(warm), _states(cold))
        assert torch.equal(warm.compute(), cold.compute())


def test_scan_rows_replay_under_their_k(tmp_path):
    d = str(tmp_path)
    _seeded_manifest(d, scan=True)
    rows = persist.load_manifest(d)
    assert [(r["kind"], r["k"]) for r in rows if r["kind"] == "scan"] == [("scan", 4)]
    with engine_context(True), scan_context(4):
        warm, cold = _acc(), _acc()
        report = persist.prewarm(warm, directory=d)
        assert report["failed"] == 0
        built = warm._engine.stats.traces
        for m in (warm, cold):
            for p, t in _stream():
                m.update(p, t)
        assert torch.equal(warm.compute(), cold.compute())
        assert warm._engine.stats.traces == built  # the drain replays the prewarmed K-bucket graph
    _assert_states_equal(_states(warm), _states(cold))


def test_fused_rows_replay_through_the_collection(tmp_path):
    d = str(tmp_path)
    with persist_context(d), engine_context(True):
        donor = _pair()
        for p, t in _stream():
            donor.update(p, t)
        donor.compute()
    assert any(r["kind"] == "fused" for r in persist.load_manifest(d))
    with engine_context(True):
        warm, cold = _pair(), _pair()
        report = persist.prewarm(warm, directory=d)
        assert report["failed"] == 0
        fe = warm._fused_engine
        assert fe is not None and fe.stats.traces == 1 and fe.stats.prewarm_replays == report["replayed"]
        for mc in (warm, cold):
            for p, t in _stream():
                mc.update(p, t)
        assert (fe.stats.traces, fe.stats.donation_copies) == (1, 0)
        got, want = warm.compute(), cold.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_a_collection_that_discovers_its_groups_reaches_the_fused_graph(tmp_path):
    """Regression members merge by value, at the first step: prewarm runs that discovery
    step on the row's zeros, then the fused row's step, so the first real update replays."""
    def pair():
        return tm.MetricCollection({"mse": tm.MeanSquaredError(device="cpu"), "mae": tm.MeanAbsoluteError(device="cpu")})

    d = str(tmp_path)
    x, y = torch.from_numpy(np.linspace(-1, 1, 20, dtype=np.float32)), torch.from_numpy(np.linspace(1, -2, 20, dtype=np.float32))
    with persist_context(d), engine_context(True):
        donor = pair()
        assert not donor._groups_checked
        for _ in range(3):
            donor.update(x, y)
        donor.compute()
    with engine_context(True):
        warm, cold = pair(), pair()
        report = persist.prewarm(warm, directory=d)
        assert report["failed"] == 0 and warm._groups_checked
        fe = warm._fused_engine
        assert fe.stats.traces == 1
        for mc in (warm, cold):
            for _ in range(3):
                mc.update(x, y)
        assert (fe.stats.traces, fe.stats.cache_hits) == (1, 3)
        got, want = warm.compute(), cold.compute()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_the_replay_order_runs_updates_first_then_computes_by_owner():
    rows = [
        {"owner": "epoch:B", "kind": "compute", "sig": "1"},
        {"owner": "A", "kind": "update", "sig": "2"},
        {"owner": "epoch:A", "kind": "sync-compute", "sig": "3"},
        {"owner": "fused:A,B", "kind": "fused", "sig": "4"},
        {"owner": "A", "kind": "update", "sig": "2"},
    ]
    ordered, duplicates = persist._replay_order(rows)
    assert [r["sig"] for r in ordered] == ["2", "4", "3", "1"] and duplicates == 1


def test_a_failed_replay_is_counted_and_not_raised(tmp_path):
    rows = [{"owner": "MulticlassAccuracy", "kind": "update", "args": [[[8, C + 2], "float32"], [[3], "int64"]], "kw": None,
             "bucket": 8, "k": None, "sig": "x"}]
    with engine_context(True):
        m = _acc()
        before = persist.persist_state()["fallbacks"]
        report = persist.prewarm(m, directory=str(tmp_path), manifest=rows)
    assert (report["replayed"], report["failed"]) == (0, 1)
    assert persist.persist_state()["fallbacks"] - before == 1
    assert m._update_count == 0


def test_prewarm_without_a_directory_is_a_noop():
    with persist_context(None), jpersist.persist_context(None):
        from torchmetrics_tpu.classification import MulticlassAccuracy as JAcc

        assert persist.prewarm(_acc()) == jpersist.prewarm(JAcc(C)) == {"entries": 0, "replayed": 0, "skipped": 0, "failed": 0}


# ------------------------------------------------------------------ warm start and the sidecar


def _donor_with_snapshot(tmp_path):
    from torchmetrics_tpu_torch.parallel.elastic import save_state_shard, shard_path

    persist_d, snaps = str(tmp_path / "persist"), str(tmp_path / "snaps")
    os.makedirs(snaps)
    with persist_context(persist_d), engine_context(True):
        donor = _acc()
        for p, t in _stream(seed=11):
            donor.update(p, t)
        value = donor.compute()
        save_state_shard(donor, shard_path(os.path.join(snaps, "snap-000001"), 0, 1))
    return persist_d, snaps, donor, value


def test_warm_start_restores_the_snapshot_on_built_graphs(tmp_path):
    from torchmetrics_tpu_torch.parallel.elastic import state_fingerprint

    persist_d, snaps, donor, value = _donor_with_snapshot(tmp_path)
    with engine_context(True):
        replica = _acc()
        report = persist.warm_start(replica, directory=persist_d, snapshot_dir=snaps)
        assert report["replayed"] == 2 and report["failed"] == 0 and report["restored_seq"] == 1
        assert state_fingerprint(replica) == state_fingerprint(donor)
        assert torch.equal(replica.compute(), value)
        # the next update continues the donor's stream on the prewarmed graph
        traces = replica._engine.stats.traces
        for m in (replica, donor):
            m.update(*_stream(seed=12)[0])
        assert replica._engine.stats.traces == traces
        _assert_states_equal(_states(replica), _states(donor))


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=20) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_the_sidecar_hands_off_before_serving(tmp_path):
    from torchmetrics_tpu_torch.serve.sidecar import MetricsSidecar

    persist_d, snaps, donor, value = _donor_with_snapshot(tmp_path)
    with engine_context(True):
        replica = _acc()
        sidecar = MetricsSidecar(port=0, warm_target=replica, persist_dir=persist_d, snapshot_dir=snaps)
        assert sidecar.warm_report is None
        with sidecar:
            report = sidecar.warm_report
            assert report["replayed"] == 2 and report["failed"] == 0 and report["restored_seq"] == 1
            assert torch.equal(replica.compute(), value)
            status, body = _get(f"http://127.0.0.1:{sidecar.port}/healthz")
            assert (status, body) == (200, b"ok\n")
            status, body = _get(f"http://127.0.0.1:{sidecar.port}/telemetry")
            assert status == 200 and json.loads(body)["persist"]["prewarm_replays"] >= 2


def test_a_failed_handoff_flips_readiness(tmp_path):
    from torchmetrics_tpu_torch.serve.sidecar import MetricsSidecar

    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    row = {"owner": "MulticlassAccuracy", "kind": "update", "args": [[[8, C + 2], "float32"], [[3], "int64"]], "kw": None,
           "bucket": 8, "k": None, "format": 1}
    row["sig"] = persist._row_signature(row)
    with open(os.path.join(d, "manifest.jsonl"), "w") as fh:
        fh.write(json.dumps(row) + "\n")
    with engine_context(True), MetricsSidecar(port=0, warm_target=_acc(), persist_dir=d) as sidecar:
        assert sidecar.warm_report["failed"] == 1
        status, body = _get(f"http://127.0.0.1:{sidecar.port}/healthz")
    assert status == 503 and json.loads(body)["reason"] == "warm-start-failed"
