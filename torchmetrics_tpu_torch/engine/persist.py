"""The signature manifest, prewarm and the warm-replica handoff (counterpart of
``torchmetrics_tpu/engine/persist.py``).

A fresh process pays for every engine build at its first step of each signature: the
guarded warm-up and, on the card, the graph capture (seconds for a deep graph). A
captured ``torch.cuda.CUDAGraph`` holds the addresses of one process's buffers and does
not serialize, so what persists across processes here is the list of signatures, and a
replacement replica rebuilds them before traffic lands:

- **The signature manifest.** Every engine build that succeeds appends one JSON line to
  ``<dir>/manifest.jsonl``: the owner, the kind, the input specs, the bucket and K-bucket
  coordinates, and ``sig``, a crc32 over them. ``CompiledUpdate`` and ``FusedUpdate``
  record kinds ``update`` and ``fused`` with the caller's inputs and the bucket
  (``engine/compiled.py``); a scan drain records ``scan`` with its per-step slot specs
  and ``k`` (``engine/scan.py``); the epoch engine records ``compute`` and
  ``sync-compute`` with no specs (``engine/epoch.py``). The rows are the JAX package's,
  key for key, and a dtype is written as its numpy name (``float32``, ``int32``), so a
  manifest written by either package parses in the other. Rows are deduplicated per
  directory (seeded from the file), each is one ``write`` of one whole line (ranks
  sharing a directory cannot tear it), and a corrupt line is skipped and counted. On
  the CPU the engines capture nothing but still record.
- **Prewarm.** :func:`prewarm` replays the rows against a live metric or collection
  before traffic lands: update, scan and fused rows through ``update`` on zero inputs
  made on the target's device (scan rows inside ``scan_context(k)``, then a flush),
  then the compute-family rows, one ``compute`` per owner, sorted by owner, so every
  rank of a process group enters the same computes (and their collectives) in the same
  order. It is value-inert: every state, the riders (``txn.ATTR``, ``sentinel.ATTR``,
  ``numerics.ATTR``), ``_update_count``, ``_computed`` and the freshness marker are
  cloned first and put back after, into the tensors the metric then holds where those
  are the engines' static buffers (``copy_``), so the captured graphs keep their
  buffers and the first real update replays without a capture or a copy into them. A
  failed replay is counted and recorded (``persist.fallback``), never raised.
- **Warm start.** :func:`warm_start` is :func:`prewarm` followed by
  ``parallel/elastic.restore_latest``, wired into ``serve/sidecar.py``'s start.
- **The executable cache.** ``store_executable`` / ``load_executable`` /
  ``try_load_executable`` keep the JAX names, artifact layout and typed errors, but a
  graph cannot be stored or loaded: ``store_executable`` answers False and records
  nothing; ``load_executable`` checks an artifact's format, compatibility envelope and
  CRC as the JAX package does and answers None even for a valid one. The engines ask
  ``try_load_executable`` once per build while persistence is on (``lookup_executable``),
  so every build is a counted miss (``persist_misses`` on its ``EngineStats``,
  ``misses`` here), where the JAX funnel counts a compile without an artifact. What
  does persist is the kernels' shared library, built once per content hash of the
  CUDA sources (``ops/_build.py``): the port's counterpart of the executable cache.

Enablement rides ``TORCHMETRICS_TPU_PERSIST=<dir>`` (:func:`persist_dir`, the one
registered fail-loud parser) or the scoped :func:`persist_context` /
:func:`set_persist_dir` overrides. Prewarm reads nothing back from the card: zeros
are made on the device and the snapshot and restore are device copies.

Kept divergences: the envelope names ``torch`` and ``cuda`` where the JAX one names
``jax`` and ``jaxlib``, and has no ``x64`` (the port has no 64-bit mode);
``native_fallback`` is always False (there is no XLA cache to fall back to); an update
row carries the caller's rows where the JAX engine records them padded to the bucket
(both replay into the same bucket's graph); a collection whose compute groups are not
settled yet runs its discovery step on a row's zeros before the replay, so the replay
reaches the fused graph; duplicate rows (ranks sharing a directory) replay once.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import zlib
from contextlib import contextmanager
from typing import Any, Dict, Generator, List, Optional, Sequence

from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "PERSIST_ENV_VAR",
    "PersistEnvelopeError",
    "PersistIntegrityError",
    "compat_envelope",
    "load_executable",
    "load_manifest",
    "persist_context",
    "persist_dir",
    "persist_state",
    "prewarm",
    "record_compile",
    "reset_persist_stats",
    "set_persist_dir",
    "store_executable",
    "try_load_executable",
    "warm_start",
]

#: env knob: a directory path enables persistence; ``"0"``/``"off"`` disable
#: explicitly; an empty value fails loud
PERSIST_ENV_VAR = "TORCHMETRICS_TPU_PERSIST"

#: artifact + manifest format, the JAX package's: an old-format file is a typed
#: rejection, never a mis-parse
PERSIST_FORMAT_VERSION = 1

_UNSET = object()
_dir_override: Any = _UNSET


class PersistIntegrityError(TorchMetricsUserError):
    """A persisted artifact is unreadable/corrupt (truncated, CRC mismatch)."""


class PersistEnvelopeError(TorchMetricsUserError):
    """A persisted artifact's compatibility envelope does not match this process."""


def persist_dir() -> Optional[str]:
    """The active persistence directory, or ``None`` (persistence off).

    Resolution: :func:`set_persist_dir` / :func:`persist_context` override first, then
    ``TORCHMETRICS_TPU_PERSIST``. The env value is a directory path (created on
    demand); ``"0"``/``"off"`` disable explicitly; an empty/whitespace value raises: a
    half-set knob must never silently disable.
    """
    if _dir_override is not _UNSET:
        return _dir_override
    raw = os.environ.get(PERSIST_ENV_VAR)
    if raw is None:
        return None
    value = raw.strip()
    if not value:
        raise TorchMetricsUserError(
            f"Invalid {PERSIST_ENV_VAR}={raw!r}: expected a cache directory path"
            " (or '0'/'off' to disable explicitly). Unset the variable to disable."
        )
    if value.lower() in ("0", "off"):
        return None
    return value


def set_persist_dir(directory: Optional[str]) -> None:
    """Force the directory process-wide; ``None`` disables."""
    global _dir_override
    _dir_override = directory


@contextmanager
def persist_context(directory: Optional[str]) -> Generator[None, None, None]:
    """Scoped persistence enablement (``None``: off inside the scope)."""
    global _dir_override
    prev = _dir_override
    _dir_override = directory
    try:
        yield
    finally:
        _dir_override = prev


# ------------------------------------------------------------------ counters

_LOCK = threading.Lock()

#: process-wide monotonic counters (builds can land from the async worker thread, so
#: every bump takes the lock; a replay never touches them)
_COUNTERS: Dict[str, float] = {  # guarded-by: _LOCK
    "hits": 0,
    "misses": 0,
    "stores": 0,
    "stored_bytes": 0,
    "deserialize_ms": 0.0,
    "envelope_rejects": 0,
    "corrupt_skips": 0,
    "fallbacks": 0,
    "prewarm_replays": 0,
    "manifest_entries": 0,
}

# manifest dedup: directory -> set of (owner, kind, sig) already on disk
_MANIFEST_SEEN: Dict[str, set] = {}  # guarded-by: _LOCK


def _bump(**deltas: float) -> None:
    with _LOCK:
        for key, delta in deltas.items():
            _COUNTERS[key] += delta


def persist_state() -> Dict[str, Any]:
    """One JSON-serializable dict for telemetry: the counters and enablement.
    ``native_fallback`` is always False: the port has no XLA cache to fall back to."""
    with _LOCK:
        out: Dict[str, Any] = dict(_COUNTERS)
    out["deserialize_ms"] = round(out["deserialize_ms"], 3)
    try:
        directory = persist_dir()
    except TorchMetricsUserError:
        directory = None
    out["enabled"] = directory is not None
    out["native_fallback"] = False
    return out


def reset_persist_stats() -> None:
    """Zero the counters (``reset_engine_stats`` calls this); the manifest and its
    dedup sets are durable state and stay."""
    with _LOCK:
        for key in _COUNTERS:
            _COUNTERS[key] = 0.0 if key == "deserialize_ms" else 0


# ------------------------------------------------------------------ envelope


def compat_envelope(device: Any = None) -> Dict[str, Any]:
    """The compatibility envelope a persisted artifact must match exactly: the torch
    and CUDA versions, the backend of ``device`` (``"cuda"`` or ``"cpu"``; the card when
    one is present and no device is named), the card's name and count, and the active
    state mesh's shape (``parallel/sharding.py``)."""
    import torch

    from torchmetrics_tpu_torch.parallel.sharding import metric_mesh

    if device is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        backend = torch.device(device).type
    on_card = backend == "cuda"
    try:
        mesh = metric_mesh()
    except TorchMetricsUserError:
        mesh = None
    mesh_shape = "" if mesh is None else "x".join(f"{k}={v}" for k, v in sorted(mesh.shape.items()))
    return {
        "format": PERSIST_FORMAT_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "backend": backend,
        "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 1,
        "mesh": mesh_shape,
    }


def _envelope_digest(envelope: Dict[str, Any]) -> str:
    payload = json.dumps(envelope, sort_keys=True).encode()
    return format(zlib.crc32(payload) & 0xFFFFFFFF, "08x")


def _artifact_path(directory: str, owner: str, kind: str, signature: str, device: Any = None) -> str:
    import hashlib

    digest = hashlib.sha256(
        f"{owner}|{kind}|{signature}|{_envelope_digest(compat_envelope(device))}".encode()
    ).hexdigest()[:32]
    return os.path.join(directory, "executables", f"{digest}.tmx")


# ------------------------------------------------------------------ artifacts


def store_executable(owner: str, kind: str, signature: str, compiled: Any, device: Any = None) -> bool:
    """A captured CUDA graph holds one process's device addresses and cannot be
    serialized: always False, nothing written, nothing counted."""
    return False


def load_executable(owner: str, kind: str, signature: str, device: Any = None) -> Optional[Any]:
    """Check one persisted artifact as the JAX package does; ``None`` when there is
    none, and ``None`` for a valid one too (a graph cannot be loaded).

    Raises :class:`PersistIntegrityError` (unreadable / truncated / CRC mismatch) or
    :class:`PersistEnvelopeError` (format or compatibility-envelope mismatch: a stale
    or cross-topology artifact). :func:`try_load_executable` counts both.
    """
    directory = persist_dir()
    if directory is None:
        return None
    path = _artifact_path(directory, owner, kind, signature, device)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as fh:
            record = pickle.loads(fh.read())
        if not isinstance(record, dict):
            raise TypeError(f"artifact root is {type(record).__name__}, expected dict")
    except Exception as exc:  # noqa: BLE001 — any unpickle failure is corruption
        raise PersistIntegrityError(
            f"persisted executable {os.path.basename(path)} is unreadable: {type(exc).__name__}: {exc}"
        ) from exc
    if record.get("format") != PERSIST_FORMAT_VERSION:
        raise PersistEnvelopeError(
            f"persisted executable {os.path.basename(path)} has format"
            f" {record.get('format')!r}, expected {PERSIST_FORMAT_VERSION}"
        )
    envelope = compat_envelope(device)
    if record.get("envelope") != envelope:
        theirs = record.get("envelope") or {}
        stale = {key: (theirs.get(key), envelope[key]) for key in envelope if theirs.get(key) != envelope[key]}
        raise PersistEnvelopeError(
            f"persisted executable {os.path.basename(path)} was built for a different environment: {stale}"
        )
    payload = record.get("payload", b"")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != record.get("crc"):
        raise PersistIntegrityError(f"persisted executable {os.path.basename(path)} failed its payload CRC")
    return None


def try_load_executable(owner: str, kind: str, signature: str, device: Any = None) -> Optional[Any]:
    """The engine-facing load: every answer is ``None``, a counted miss; a stale
    envelope or a corrupt artifact is also counted apart and recorded
    (``persist.fallback``)."""
    try:
        loaded = load_executable(owner, kind, signature, device)
    except PersistEnvelopeError as exc:
        _bump(envelope_rejects=1, misses=1)
        _diag.record("persist.fallback", owner, exe_kind=kind, reason=f"envelope:{exc}")
        return None
    except PersistIntegrityError as exc:
        _bump(corrupt_skips=1, misses=1)
        _diag.record("persist.fallback", owner, exe_kind=kind, reason=f"corrupt:{exc}")
        return None
    _bump(misses=1)
    return loaded


def lookup_executable(stats: Any, owner: str, kind: str, signature: str, device: Any = None) -> None:
    """The engines' lookup at each build while persistence is on: one
    :func:`try_load_executable`, a miss on ``stats.persist_misses`` (a graph is never
    loaded, so the build goes on)."""
    if persist_dir() is None:
        return
    try_load_executable(owner, kind, signature, device)
    stats.persist_misses += 1


# ------------------------------------------------------------------ manifest


def _manifest_path(directory: str) -> str:
    return os.path.join(directory, "manifest.jsonl")


def _dtype_name(value: Any) -> str:
    """A value's dtype as numpy names it (``torch.float32`` -> ``"float32"``), or its
    type's name when it has none, as the JAX rows write it."""
    dtype = getattr(value, "dtype", None)
    if dtype is None:
        return type(value).__name__
    return str(dtype).replace("torch.", "")


def _spec(value: Any) -> List[Any]:
    return [[int(d) for d in getattr(value, "shape", ())], _dtype_name(value)]


def _row_signature(row: Dict[str, Any]) -> str:
    body = json.dumps(
        [row.get("owner"), row.get("kind"), row.get("args"), row.get("kw"), row.get("bucket"), row.get("k")],
        sort_keys=True,
    ).encode()
    return format(zlib.crc32(body) & 0xFFFFFFFF, "08x")


def load_manifest(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """Every recorded manifest row, in append order. Corrupt lines (torn writes,
    foreign content) are skipped, counted (``corrupt_skips``) and recorded."""
    directory = persist_dir() if directory is None else directory
    if directory is None:
        return []
    path = _manifest_path(directory)
    if not os.path.exists(path):
        return []
    rows: List[Dict[str, Any]] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
                if not isinstance(row, dict) or "owner" not in row or "kind" not in row:
                    raise ValueError("not a manifest row")
            except (json.JSONDecodeError, ValueError) as exc:
                _bump(corrupt_skips=1)
                _diag.record("persist.fallback", "persist", reason=f"manifest-line-{lineno}:{type(exc).__name__}")
                continue
            rows.append(row)
    return rows


def record_compile(
    owner: str,
    kind: str,
    args: Optional[Sequence[Any]] = None,
    kw: Optional[Dict[str, Any]] = None,
    bucket: Optional[int] = None,
    k: Optional[int] = None,
) -> None:
    """Append one (owner, kind, specs, bucket / K coordinates, sig) manifest row, the
    engines' call after a build succeeds. Dedup is in memory per directory, seeded from
    the file, so a restart does not re-append the rows it replays. No-op with
    persistence off."""
    directory = persist_dir()
    if directory is None:
        return
    row: Dict[str, Any] = {
        "format": PERSIST_FORMAT_VERSION,
        "owner": owner,
        "kind": kind,
        "args": [_spec(a) for a in args] if args is not None else None,
        "kw": {name: _spec(v) for name, v in sorted(kw.items())} if kw else None,
        "bucket": bucket,
        "k": k,
    }
    row["sig"] = _row_signature(row)
    dedup_key = (owner, kind, row["sig"])
    with _LOCK:
        seen = _MANIFEST_SEEN.get(directory)
        preload = seen is None
        if preload:
            seen = _MANIFEST_SEEN[directory] = set()
    if preload:
        for existing in load_manifest(directory):
            seen.add((existing.get("owner"), existing.get("kind"), existing.get("sig")))
    line = (json.dumps(row, sort_keys=True) + "\n").encode()
    with _LOCK:
        if dedup_key in seen:
            return
        seen.add(dedup_key)
        os.makedirs(directory, exist_ok=True)
        # one write of one whole line on an O_APPEND descriptor: processes sharing the
        # directory interleave whole rows, never parts of one
        fd = os.open(_manifest_path(directory), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
            os.fsync(fd)
        finally:
            os.close(fd)
    _bump(manifest_entries=1)
    _diag.record("persist.manifest", owner, exe_kind=kind, signature=row["sig"], bucket=bucket, k=k)


# ------------------------------------------------------------------ prewarm

_UPDATE_KINDS = ("update", "scan", "fused")
_COMPUTE_KINDS = ("compute", "sync-compute", "sync-fold")


def _torch_dtype(name: str) -> Any:
    import numpy as np
    import torch

    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def _zeros(spec: Sequence[Any], device: Any) -> Any:
    """A zero input of ``spec`` made on ``device``: a fill on the card, never a copy
    from the host."""
    import torch

    shape, dtype = spec
    return torch.zeros(tuple(shape), dtype=_torch_dtype(dtype), device=device)


def _rider_attrs() -> tuple:
    from torchmetrics_tpu_torch.diag import sentinel
    from torchmetrics_tpu_torch.engine import numerics, txn

    return (sentinel.ATTR, txn.ATTR, numerics.ATTR)


def _clone(value: Any) -> Any:
    import torch

    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, list):
        return [_clone(v) for v in value]
    if isinstance(value, dict):
        return {name: _clone(v) for name, v in value.items()}
    return value


def _snapshot_metric(metric: Any) -> Dict[str, Any]:
    """Device-side clones of everything a replay could change: the registered states,
    the rider tensors, the update bookkeeping and the freshness marker. A clone, not a
    reference: a replay writes the engines' static buffers in place."""
    saved: Dict[str, Any] = {"states": {}, "riders": {}, "absent": []}
    for attr in metric._defaults:
        saved["states"][attr] = _clone(getattr(metric, attr))
    for attr in _rider_attrs():
        if attr in metric.__dict__:
            saved["riders"][attr] = _clone(metric.__dict__[attr])
        else:
            saved["absent"].append(attr)
    saved["update_count"] = getattr(metric, "_update_count", None)
    saved["computed"] = getattr(metric, "_computed", None)
    saved["fresh"] = metric.__dict__.get("_state_fresh")
    return saved


def _put_back(held: Any, value: Any) -> Any:
    """``value`` written into ``held`` when ``held`` is an engine's static buffer of the
    same layout (the graphs keep their addresses), else ``value`` itself."""
    import torch

    from torchmetrics_tpu_torch.engine.compiled import is_static
    from torchmetrics_tpu_torch.parallel import sharding

    if not (isinstance(value, torch.Tensor) and is_static(held) and type(held) is type(value)):
        return value
    dst, src = sharding.local(held), sharding.local(value)
    if dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device:
        return value
    with torch.no_grad():
        dst.copy_(src)
    return held


def _restore_metric(metric: Any, saved: Dict[str, Any]) -> None:
    for attr, value in saved["states"].items():
        held = getattr(metric, attr)
        restored = _put_back(held, value)
        if restored is not held:
            setattr(metric, attr, restored)
    for attr, value in saved["riders"].items():
        held = metric.__dict__.get(attr)
        if isinstance(value, dict):
            held = held if isinstance(held, dict) else {}
            metric.__dict__[attr] = {name: _put_back(held.get(name), v) for name, v in value.items()}
        else:
            metric.__dict__[attr] = _put_back(held, value)
    for attr in saved["absent"]:
        metric.__dict__.pop(attr, None)
    if saved["update_count"] is not None:
        metric._update_count = saved["update_count"]
    metric._computed = saved["computed"]
    if saved["fresh"] is not None:
        metric.__dict__["_state_fresh"] = saved["fresh"]


def _target_metrics(obj: Any) -> List[Any]:
    if hasattr(obj, "_defaults"):  # duck-typed Metric
        return [obj]
    if hasattr(obj, "_modules"):  # duck-typed MetricCollection
        return list(obj._modules.values())
    raise TorchMetricsUserError(f"prewarm expects a Metric or MetricCollection, got {type(obj).__name__}")


def _update_target(obj: Any, owner: str) -> Any:
    """The replay target of an update-family row: for a ``fused:A,B`` owner (the group
    representatives ``engine/fusion.py`` fuses) a collection whose member types cover
    those names; for a bare owner the member (or the metric) of that type."""
    if owner.startswith("fused:"):
        if not hasattr(obj, "_modules"):
            return None
        member_types = {type(m).__name__ for m in obj._modules.values()}
        return obj if set(owner[len("fused:"):].split(",")) <= member_types else None
    return next((m for m in _target_metrics(obj) if type(m).__name__ == owner), None)


def _compute_target(obj: Any, owner: str) -> Any:
    if hasattr(obj, "_modules") and owner.startswith("epoch:collection["):
        return obj
    return next((m for m in _target_metrics(obj) if owner == f"epoch:{type(m).__name__}"), None)


def _replay_row(obj: Any, row: Dict[str, Any], computed_owners: set) -> bool:
    """Replay ONE manifest row against ``obj``; True when it dispatched.

    Update and scan rows replay through the target's ``update`` (scan rows inside a
    ``scan_context(k)`` so the drain builds the recorded K-bucket); fused rows through
    the collection's ``update``; compute-family rows through ONE ``compute()`` per
    owner: the graphs the current topology needs.
    """
    kind = row.get("kind")
    owner = row.get("owner", "")
    if kind in _UPDATE_KINDS:
        target = _update_target(obj, owner)
        if target is None:
            return False
        device = _target_metrics(target)[0].device
        args = [_zeros(spec, device) for spec in row.get("args") or []]
        kw = {name: _zeros(spec, device) for name, spec in (row.get("kw") or {}).items()}
        if getattr(target, "_enable_compute_groups", False) and not target._groups_checked:
            target.update(*args, **kw)  # the discovery step: the next one reaches the fused graph
        if kind == "scan":
            from torchmetrics_tpu_torch.engine.scan import flush_metrics, scan_context

            kb = int(row.get("k") or 8)
            with scan_context(k=kb):
                for _ in range(kb):
                    target.update(*args, **kw)
                flush_metrics(_target_metrics(obj), "prewarm")
        else:
            target.update(*args, **kw)
        return True
    if kind in _COMPUTE_KINDS:
        if owner in computed_owners:
            return False
        target = _compute_target(obj, owner)
        if target is None:
            return False
        computed_owners.add(owner)
        target.compute()
        return True
    return False


def _replay_order(rows: List[Dict[str, Any]]) -> tuple:
    """``(ordered rows, duplicates)``: the update-family rows in append order, then the
    compute-family rows sorted by owner (every rank enters the same computes in the same
    order); other kinds keep their place among the first. A repeated (owner, kind, sig)
    replays once."""
    seen: set = set()
    first: List[Dict[str, Any]] = []
    computes: List[Dict[str, Any]] = []
    duplicates = 0
    for row in rows:
        key = (row.get("owner"), row.get("kind"), row.get("sig"))
        if key in seen:
            duplicates += 1
            continue
        seen.add(key)
        (computes if row.get("kind") in _COMPUTE_KINDS else first).append(row)
    computes.sort(key=lambda r: (str(r.get("owner", "")), str(r.get("kind", ""))))
    return first + computes, duplicates


def prewarm(obj: Any, directory: Optional[str] = None, manifest: Optional[List[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Replay the recorded signature manifest so every graph is built (captured on the
    card) before traffic lands.

    Value-inert: states, riders and update bookkeeping are cloned on the device before
    the replays and put back after. Failed replays are counted and recorded
    (``persist.fallback``), never raised: a half-warm replica must still serve. The
    report: ``entries`` (rows read), ``replayed``, ``skipped`` (no target, a compute
    owner already run, a duplicate row), ``failed``, ``hits`` and ``misses``.
    """
    directory = persist_dir() if directory is None else directory
    report: Dict[str, Any] = {"entries": 0, "replayed": 0, "skipped": 0, "failed": 0}
    if directory is None:
        return report
    rows = load_manifest(directory) if manifest is None else list(manifest)
    report["entries"] = len(rows)
    if not rows:
        return report
    ordered, report["skipped"] = _replay_order(rows)
    before = persist_state()
    metrics = _target_metrics(obj)
    saved = [_snapshot_metric(m) for m in metrics]
    computed_owners: set = set()
    import warnings

    with persist_context(directory):
        try:
            # the replay is a deliberate value-inert probe: compute-before-update style
            # advisories would fire on compute rows and mean nothing here
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                for row in ordered:
                    try:
                        if _replay_row(obj, row, computed_owners):
                            report["replayed"] += 1
                        else:
                            report["skipped"] += 1
                    except Exception as exc:  # noqa: BLE001 — a half-warm replica must serve
                        report["failed"] += 1
                        _bump(fallbacks=1)
                        _diag.record(
                            "persist.fallback", row.get("owner", ""),
                            exe_kind=row.get("kind", ""), reason=f"replay:{type(exc).__name__}: {exc}",
                        )
        finally:
            for m, snap in zip(metrics, saved):
                _restore_metric(m, snap)
    after = persist_state()
    report["hits"] = int(after["hits"] - before["hits"])
    report["misses"] = int(after["misses"] - before["misses"])
    _bump(prewarm_replays=report["replayed"])
    # the replays on ONE live engine, so engine_report() carries them: the collection's
    # fused engine when there is one, else the first member's update engine
    for holder in (getattr(obj, "_fused_engine", None), *(getattr(m, "_engine", None) for m in metrics)):
        if holder is not None:
            holder.stats.prewarm_replays += report["replayed"]
            break
    _diag.record(
        "persist.prewarm", type(obj).__name__,
        entries=report["entries"], replayed=report["replayed"], skipped=report["skipped"],
        failed=report["failed"], hits=report["hits"], misses=report["misses"],
    )
    return report


def warm_start(
    obj: Any,
    directory: Optional[str] = None,
    snapshot_dir: Optional[str] = None,
    rank: int = 0,
    world_size: int = 1,
) -> Dict[str, Any]:
    """The warm-replica handoff in one call: :func:`prewarm` every recorded signature,
    then ``parallel/elastic.restore_latest`` the newest durable snapshot, so a
    replacement replica serves restored states on built graphs from its first request.
    Prewarm runs first, so the restore lands on an already-built compute path; restore
    errors propagate (the elastic layer's typed contract), replay failures are counted
    per row."""
    report = prewarm(obj, directory)
    if snapshot_dir is not None:
        from torchmetrics_tpu_torch.parallel.elastic import restore_latest

        report["restored_seq"] = restore_latest(obj, snapshot_dir, rank=rank, world_size=world_size)
    return report
