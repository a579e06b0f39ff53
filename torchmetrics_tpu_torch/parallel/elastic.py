"""Elastic snapshots: shards saved by an N-rank world restore into an M-rank world
(counterpart of ``torchmetrics_tpu/parallel/elastic.py``, with the same file layout, so
a shard set written by either package restores into the other).

- ``save_state_shard``: one atomic (``.tmp``, ``fsync``, ``os.replace``) ``.npz`` of
  this rank's full state and update count, stamped ``__elastic_version__``,
  ``__rank__``, ``__world__`` and ``__crc__`` (crc32 over every entry's name, dtype,
  shape and bytes: the JAX digest). A crash mid-write leaves only a ``.tmp`` file,
  which restore ignores.
- ``restore_resharded``: loads the complete shard set of the saved world and restores
  it as ``rank`` of ``world_size``. The same world restores shard by shard (every
  state kind); another world folds the shards through a ``PackedSyncPlan`` built at
  restore time (compensation off) and its ``make_fold()``, the live sync's own fold,
  then splits the result so that an M-rank sync reproduces the N-rank fold:

  =============  =========================================================
  ``sum``        new rank 0 carries the folded total, the others zeros
  ``mean``       the folded mean on every rank
  ``max/min``    the folded extremum on every rank
  ``cat``        the concatenated rows in contiguous chunks, in rank order
  ``custom``/``none``  ``SnapshotReshardError`` (no fold algebra survives a resize)
  =============  =========================================================

  The states land on the metric's own device (the card unless it was built with
  ``device="cpu"``), and the fold runs there.
- Integrity fails loud: a CRC mismatch, an unreadable archive or an incomplete set
  raises ``SnapshotIntegrityError``, another layout version ``SnapshotVersionError``;
  ``last_good`` names a shard set to fall back to (a ``snapshot.fallback`` event).
- ``SnapshotPolicy`` (``TORCHMETRICS_TPU_SNAPSHOT_EVERY``: ``"500"`` updates or
  ``"30s"``), ``ContinuousSnapshotter`` (numbered sequences
  ``snap-000042.rank0-of-2.npz``, pruned per rank, and a SIGTERM / SIGINT handler that
  flushes a final shard before the process dies, or stands on the last flush when the
  signal landed inside an update: ``_mutation_depth``) and ``restore_latest`` (the
  newest complete, clean sequence).

A ``state_dict`` drains the scan queue and joins the async drains first, so a shard
written while steps are queued holds the drained state.
"""

from __future__ import annotations

import os
import re
import signal as _signal
import time as _time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "SNAPSHOT_EVERY_ENV_VAR",
    "SNAPSHOT_VERSION",
    "ContinuousSnapshotter",
    "SnapshotIntegrityError",
    "SnapshotPolicy",
    "SnapshotReshardError",
    "SnapshotVersionError",
    "list_snapshots",
    "restore_latest",
    "restore_resharded",
    "save_state_shard",
    "shard_path",
    "state_fingerprint",
]

#: the layout version; a snapshot of another version fails loud
SNAPSHOT_VERSION = 1

_META_KEYS = ("__elastic_version__", "__rank__", "__world__", "__crc__")


class SnapshotIntegrityError(TorchMetricsUserError):
    """The snapshot is corrupt (CRC mismatch, unreadable, incomplete set)."""


class SnapshotVersionError(TorchMetricsUserError):
    """The snapshot was written by another layout version."""


class SnapshotReshardError(TorchMetricsUserError):
    """This state layout cannot be resharded into another world size."""


def shard_path(base: str, rank: int, world_size: int) -> str:
    """The shard file of ``rank`` of ``world_size`` under ``base``."""
    return f"{base}.rank{int(rank)}-of-{int(world_size)}.npz"


def _payload_crc(flat: Dict[str, np.ndarray]) -> int:
    """Order-independent digest over every payload entry's name, dtype, shape and bytes."""
    crc = 0
    for key in sorted(flat):
        if key in _META_KEYS:
            continue
        arr = np.ascontiguousarray(flat[key])
        header = f"{key}|{arr.dtype}|{arr.shape}|".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(header, crc))
    return crc & 0xFFFFFFFF


def _collect_flat(metric: Any) -> Dict[str, np.ndarray]:
    """This rank's full state (persistence forced on) as host arrays; ``state_dict``
    drains queued steps first."""
    from torchmetrics_tpu_torch.utilities.checkpoint import (
        _restore_persistence,
        _snapshot_persistence,
        _to_saveable,
    )

    saved_flags = _snapshot_persistence(metric)
    try:
        metric.persistent(True)
        return {k: np.asarray(v) for k, v in _to_saveable(metric.state_dict()).items()}
    finally:
        _restore_persistence(metric, saved_flags)


def state_fingerprint(metric: Any) -> int:
    """The digest ``save_state_shard`` stamps, over the metric's full persisted state
    (values and update count)."""
    return _payload_crc(_collect_flat(metric))


def save_state_shard(metric: Any, path: str, rank: int = 0, world_size: int = 1) -> str:
    """Atomically write this rank's full state to ``path`` (``.npz`` appended when
    missing): the file exists complete or not at all. Returns the final path."""
    flat = _collect_flat(metric)
    flat["__elastic_version__"] = np.asarray(SNAPSHOT_VERSION)
    flat["__rank__"] = np.asarray(int(rank))
    flat["__world__"] = np.asarray(int(world_size))
    flat["__crc__"] = np.asarray(_payload_crc(flat), dtype=np.uint32)

    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    # a file object: np.savez must not append its own extension to the tmp name
    with open(tmp, "wb") as fh:
        np.savez(fh, **flat)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, final)
    _diag.record("snapshot.save", type(metric).__name__, path=final, rank=int(rank), world=int(world_size))
    return final


# ------------------------------------------------------------------ load and verify


def _load_shard(path: str) -> Dict[str, np.ndarray]:
    try:
        with np.load(path, allow_pickle=False) as npz:
            flat = {k: np.asarray(npz[k]) for k in npz.files}
    except Exception as err:  # noqa: BLE001 -- an unreadable archive is the corruption signal
        raise SnapshotIntegrityError(f"snapshot shard {path!r} is unreadable: {err}") from err
    for key in _META_KEYS:
        if key not in flat:
            raise SnapshotIntegrityError(
                f"snapshot shard {path!r} lacks the {key} stamp: not an elastic shard"
                " (or written by a pre-elastic layout)"
            )
    version = int(flat["__elastic_version__"])
    if version != SNAPSHOT_VERSION:
        raise SnapshotVersionError(
            f"snapshot shard {path!r} has layout version {version}, this build reads"
            f" {SNAPSHOT_VERSION}: refusing to guess at the layout"
        )
    expected = int(flat["__crc__"])
    actual = _payload_crc(flat)
    if actual != expected:
        raise SnapshotIntegrityError(
            f"snapshot shard {path!r} failed its integrity check"
            f" (crc {actual:#010x} != stamped {expected:#010x}): the payload is corrupt"
        )
    return flat


def _resolve_shards(shards: Union[str, Sequence[str]]) -> List[str]:
    """A directory (complete ``.npz`` shards only, never a ``.tmp`` leftover) or an
    explicit path list."""
    if isinstance(shards, (str, os.PathLike)):
        root = os.fspath(shards)
        if os.path.isdir(root):
            found = sorted(
                os.path.join(root, name) for name in os.listdir(root) if name.endswith(".npz") and ".tmp" not in name
            )
            if not found:
                raise SnapshotIntegrityError(f"no snapshot shards found under {root!r}")
            return found
        return [root]
    return [os.fspath(p) for p in shards]


def _load_shard_set(shards: Union[str, Sequence[str]]) -> List[Dict[str, np.ndarray]]:
    loaded = [_load_shard(p) for p in _resolve_shards(shards)]
    world = {int(f["__world__"]) for f in loaded}
    if len(world) != 1:
        raise SnapshotIntegrityError(f"snapshot shards disagree on their saved world size ({sorted(world)})")
    n = world.pop()
    ranks = sorted(int(f["__rank__"]) for f in loaded)
    if ranks != list(range(n)):
        raise SnapshotIntegrityError(f"incomplete snapshot shard set: saved world {n} but ranks {ranks} present")
    return sorted(loaded, key=lambda f: int(f["__rank__"]))


# ------------------------------------------------------------------ reshard


def _is_metric(obj: Any) -> bool:
    return hasattr(obj, "_defaults") and hasattr(obj, "_reductions")


def _set_states(metric: Any, states: Dict[str, Any]) -> None:
    for k, v in states.items():
        object.__setattr__(metric, k, v)


def _as_state(metric: Any, attr: str, value: Any) -> Any:
    """A loaded array (or list of arrays) as a tensor on the metric's device; a raw
    sentence in a list state stays a ``str``. A tensor state takes its registered
    default's dtype when both are integer or both floating, refusing values that do not
    fit (a JAX shard written in 64-bit mode holds int64 counters and float64 sums)."""
    default = metric._defaults[attr]

    def one(arr: Any) -> Any:
        arr = np.array(arr)
        if arr.dtype.kind == "U":
            return str(arr)
        if isinstance(default, torch.Tensor):
            want = torch.empty((), dtype=default.dtype).numpy().dtype
            if arr.dtype.kind in "iu" and want.kind in "iu":
                info = np.iinfo(want)
                if arr.size and (arr.min() < info.min or arr.max() > info.max):
                    raise SnapshotIntegrityError(
                        f"state {attr!r} holds values in [{arr.min()}, {arr.max()}] that do not fit {default.dtype}"
                    )
                arr = arr.astype(want)
            elif arr.dtype.kind == "f" and want.kind == "f" and arr.dtype != want:
                with np.errstate(over="ignore"):
                    cast = arr.astype(want)
                if np.any(np.isfinite(arr) & ~np.isfinite(cast)):
                    raise SnapshotIntegrityError(f"state {attr!r} holds finite values that overflow {default.dtype}")
                arr = cast
        return torch.as_tensor(arr, device=metric.device)

    return [one(v) for v in value] if isinstance(value, list) else one(value)


def _fold_shards(metric: Any, shard_states: List[Dict[str, Any]]) -> Tuple[Dict[str, Any], Any]:
    """Fold N shards' states through a ``PackedSyncPlan`` built for the snapshot's
    world, the live sync's own machinery: one plan per shard (the same layout, checked
    by signature), the shared metadata table, and ``make_fold()``."""
    from torchmetrics_tpu_torch.engine import numerics
    from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan

    n = len(shard_states)
    original = {k: getattr(metric, k) for k in metric._defaults}
    try:
        # shard values are anchored (state_dict folded each residual in) and carry no
        # residual: the plan is built with compensation off, plain sum / mean specs
        with numerics.compensated_context(False):
            plans, metas = [], []
            for states in shard_states:
                _set_states(metric, states)
                plan = PackedSyncPlan([("", metric)], n)
                plans.append(plan)
                metas.append(plan.metadata_local())
        if len({None if m is None else m.shape for m in metas}) != 1:
            raise SnapshotReshardError(
                "snapshot shards disagree on the packed metadata layout: they were not written"
                " by the same metric definition"
            )
        world_meta = None if metas[0] is None else np.stack(metas)
        packed = []
        for plan, states in zip(plans, shard_states):
            _set_states(metric, states)
            plan.finalize(world_meta)
            packed.append(plan.pack())
        if len({p.signature() for p in plans}) != 1:
            raise SnapshotReshardError(
                "snapshot shards disagree on the packed buffer layout: mismatched state shapes"
                " or dtypes across shards"
            )
        gathered = {key: torch.stack([p[key] for p in packed]) for key in packed[0]}
        return plans[0].make_fold()(gathered).get("", {}), plans[0]
    finally:
        _set_states(metric, original)


def _chunk_rows(n_rows: int, rank: int, world_size: int) -> Tuple[int, int]:
    """The contiguous row chunk ``[start, stop)`` of ``rank`` of ``world_size``."""
    base, rem = divmod(n_rows, world_size)
    start = rank * base + min(rank, rem)
    return start, start + base + (1 if rank < rem else 0)


def _split_count(total: int, rank: int, world_size: int) -> int:
    """A sum-preserving integer split of the aggregate update count."""
    base, rem = divmod(int(total), world_size)
    return base + (1 if rank < rem else 0)


def _reshard_metric(
    metric: Any, shard_flats: List[Dict[str, np.ndarray]], rank: int, world_size: int, prefix: str = ""
) -> None:
    from torchmetrics_tpu_torch.engine import numerics
    from torchmetrics_tpu_torch.utilities.checkpoint import _from_saveable

    n = len(shard_flats)
    count_key = prefix + metric._UPDATE_COUNT_KEY
    shard_states = []
    counts = []
    for flat in shard_flats if n != world_size else [shard_flats[rank]]:
        restored = _from_saveable({k: v for k, v in flat.items() if k not in _META_KEYS})
        states = {}
        for attr in metric._defaults:
            key = prefix + attr
            if key not in restored:
                raise SnapshotIntegrityError(f"snapshot shard lacks state {key!r}: saved by a different metric?")
            states[attr] = _as_state(metric, attr, restored[key])
        shard_states.append(states)
        counts.append(int(restored.get(count_key, 0)))
    if n == world_size:
        # the same world: this rank's own shard, every state kind supported
        metric.load_state_dict({**{prefix + k: v for k, v in shard_states[0].items()}, count_key: counts[0]}, prefix=prefix)
        return

    folded, plan = _fold_shards(metric, shard_states)
    out: Dict[str, Any] = {}
    for spec in plan.specs:
        attr = spec.attr
        if attr not in metric._defaults:  # a rider
            continue
        value = folded[attr]
        if spec.kind == "sum":
            out[attr] = value if rank == 0 else torch.zeros_like(value)
        elif spec.kind in ("mean", "max", "min"):
            out[attr] = value  # idempotent folds replicate exactly
        elif spec.kind == "cat":
            if isinstance(value, list):  # empty on every shard
                out[attr] = []
                continue
            start, stop = _chunk_rows(int(value.shape[0]), rank, world_size)
            chunk = value[start:stop]
            out[attr] = ([chunk] if chunk.shape[0] else []) if spec.was_list else chunk
        else:
            raise SnapshotReshardError(
                f"state {attr!r} ({spec.kind} reduction) cannot be resharded from a"
                f" {n}-rank snapshot into a {world_size}-rank world: no fold algebra"
                " survives the resize. Restore into the saved world size, or rebuild"
                " the state from data."
            )
    for attr, value in out.items():
        setattr(metric, attr, value)
    metric._update_count = _split_count(sum(counts), rank, world_size)
    metric._computed = None
    # the fold ran on whole states: rule-carrying ones re-place onto the state mesh
    metric._apply_shard_rules()
    if metric.__dict__.get(numerics.ATTR):
        # shards persist anchored totals: the restored world compensates from zero
        metric.__dict__[numerics.ATTR] = {k: torch.zeros_like(v) for k, v in metric.__dict__[numerics.ATTR].items()}


def restore_resharded(
    metric: Any,
    shards: Union[str, Sequence[str]],
    rank: int = 0,
    world_size: int = 1,
    last_good: Optional[Union[str, Sequence[str]]] = None,
) -> Any:
    """Restore a saved N-rank shard set into this process as ``rank`` of ``world_size``.

    ``shards`` is the complete shard set of the saved world: a directory (leftover
    ``.tmp`` files ignored) or explicit paths. Works for a ``Metric`` and for a
    ``MetricCollection`` (each compute group's owner reshards once, then the views
    re-anchor). A corrupt or version-mismatched set raises on every rank; ``last_good``
    names a previous complete set to restore instead (recorded, never silent).
    """
    if world_size < 1 or not (0 <= rank < world_size):
        raise ValueError(f"invalid target geometry: rank {rank} of world {world_size}")
    try:
        shard_flats = _load_shard_set(shards)
    except (SnapshotIntegrityError, SnapshotVersionError) as err:
        if last_good is None:
            raise
        _diag.record("snapshot.fallback", type(metric).__name__, error=type(err).__name__, detail=str(err)[:200])
        return restore_resharded(metric, last_good, rank=rank, world_size=world_size)

    # queued steps fold in first, as load_state_dict has them do
    metric._drain_scan("observation:load_state_dict")
    if _is_metric(metric):
        _reshard_metric(metric, shard_flats, rank, world_size)
    elif getattr(metric, "_groups_checked", False) and getattr(metric, "_groups", None):
        # a grouped collection: each group's owner reshards once, then the views
        # re-anchor onto the restored owners
        grouped: set = set()
        for group in metric._groups.values():
            grouped.update(group.names)
            _reshard_metric(metric._modules[group.owner], shard_flats, rank, world_size, prefix=f"{group.owner}.")
        for name, member in metric._modules.items():
            if name not in grouped:
                _reshard_metric(member, shard_flats, rank, world_size, prefix=f"{name}.")
        metric._state_is_copy = False
        metric._materialize_group_views()
    else:
        for name, member in metric.items(keep_base=True, copy_state=False):
            _reshard_metric(member, shard_flats, rank, world_size, prefix=f"{name}.")
    _diag.record(
        "snapshot.restore", type(metric).__name__, saved_world=len(shard_flats), rank=int(rank), world=int(world_size)
    )
    return metric


# ------------------------------------------------------------------ continuous snapshots

#: cadence: ``"500"`` = every 500 updates, ``"30s"`` / ``"2.5s"`` = every 30 / 2.5
#: seconds; unset = no automatic cadence (flushes and signals only)
SNAPSHOT_EVERY_ENV_VAR = "TORCHMETRICS_TPU_SNAPSHOT_EVERY"

_SNAP_RE = re.compile(r"snap-(\d+)\.rank(\d+)-of-(\d+)\.npz$")


class SnapshotPolicy:
    """Snapshot cadence: every N updates and/or every T seconds, counted from the last
    snapshot (with ``every_updates=N`` the Nth update since the previous flush
    snapshots)."""

    __slots__ = ("every_updates", "every_seconds")

    def __init__(self, every_updates: Optional[int] = None, every_seconds: Optional[float] = None) -> None:
        self.every_updates = int(every_updates) if every_updates is not None else None
        self.every_seconds = float(every_seconds) if every_seconds is not None else None
        if self.every_updates is not None and self.every_updates < 1:
            raise ValueError(f"every_updates must be >= 1 (got {every_updates})")
        if self.every_seconds is not None and self.every_seconds <= 0:
            raise ValueError(f"every_seconds must be > 0 (got {every_seconds})")

    @classmethod
    def from_env(cls) -> Optional["SnapshotPolicy"]:
        """Parse ``TORCHMETRICS_TPU_SNAPSHOT_EVERY``; None only when unset. An invalid
        value raises: a silently disabled cadence loses data at the next preemption."""
        raw = os.environ.get(SNAPSHOT_EVERY_ENV_VAR, "").strip().lower()
        if not raw:
            return None
        try:
            if raw.endswith("s"):
                return cls(every_seconds=float(raw[:-1]))
            return cls(every_updates=int(raw))
        except ValueError as exc:
            raise TorchMetricsUserError(
                f"invalid {SNAPSHOT_EVERY_ENV_VAR}={raw!r}: use an update count"
                " ('500') or a seconds suffix ('30s'); refusing to run with the"
                " snapshot cadence silently disabled."
            ) from exc

    def due(self, updates_since: int, seconds_since: float) -> bool:
        """Whether a snapshot is due, given the progress since the last one."""
        if self.every_updates is not None and updates_since >= self.every_updates:
            return True
        return self.every_seconds is not None and seconds_since >= self.every_seconds


def _snapshot_base(directory: str, seq: int) -> str:
    return os.path.join(directory, f"snap-{int(seq):06d}")


def list_snapshots(directory: str) -> List[Tuple[int, List[str]]]:
    """``[(seq, [shard paths])]`` for every snapshot sequence, oldest first (``.tmp``
    leftovers never match)."""
    by_seq: Dict[int, List[str]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        match = _SNAP_RE.fullmatch(name)
        if match:
            by_seq.setdefault(int(match.group(1)), []).append(os.path.join(directory, name))
    return [(seq, sorted(by_seq[seq])) for seq in sorted(by_seq)]


class ContinuousSnapshotter:
    """Cadence-driven atomic snapshots and a preemption flush for one metric (or
    collection).

    Each flush writes the next numbered sequence through ``save_state_shard``; this
    rank's shards older than the newest ``keep`` are pruned after every flush.
    ``install_signal_handlers`` (or the ``with`` block) arms SIGTERM and SIGINT: the
    handler flushes a final shard, restores the previous handler and raises the signal
    again, so the process still dies, with the last-good chain ending at the signal.
    Handlers install on the main thread only (Python's signal contract).
    """

    def __init__(
        self,
        metric: Any,
        directory: str,
        rank: int = 0,
        world_size: int = 1,
        policy: Optional[SnapshotPolicy] = None,
        keep: int = 2,
        clock: Callable[[], float] = _time.monotonic,
    ) -> None:
        self.metric = metric
        self.directory = os.fspath(directory)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.policy = policy if policy is not None else SnapshotPolicy.from_env()
        self.keep = max(1, int(keep))
        self._clock = clock
        os.makedirs(self.directory, exist_ok=True)
        existing = list_snapshots(self.directory)
        self._seq = existing[-1][0] if existing else 0
        self._updates_since = 0
        self._last_flush = self._clock()
        self._prev_handlers: Dict[int, Any] = {}
        self.flushes = 0

    @property
    def seq(self) -> int:
        """The number of the last completed snapshot sequence (0 = none yet)."""
        return self._seq

    def note_update(self) -> Optional[str]:
        """Record one metric update; snapshot when the cadence says so (the shard path)."""
        self._updates_since += 1
        if self.policy is not None and self.policy.due(self._updates_since, self._clock() - self._last_flush):
            return self.flush(reason="cadence")
        return None

    def flush(self, reason: str = "manual") -> str:
        """Write the next numbered snapshot sequence now."""
        seq = self._seq + 1
        path = save_state_shard(
            self.metric,
            shard_path(_snapshot_base(self.directory, seq), self.rank, self.world_size),
            rank=self.rank,
            world_size=self.world_size,
        )
        # only a written shard advances the completed-sequence watermark
        self._seq = seq
        self._updates_since = 0
        self._last_flush = self._clock()
        self.flushes += 1
        _diag.record(
            "snapshot.flush", type(self.metric).__name__,
            seq=self._seq, reason=reason, rank=self.rank, world=self.world_size,
        )
        self._prune()
        return path

    def _prune(self) -> None:
        """Drop this rank's shards beyond its own newest ``keep`` sequences."""
        mine = []
        for seq, paths in list_snapshots(self.directory):
            shard = shard_path(_snapshot_base(self.directory, seq), self.rank, self.world_size)
            if shard in paths:
                mine.append((seq, shard))
        mine.sort(reverse=True)
        for _seq, stale in mine[self.keep :]:
            try:
                os.remove(stale)
            except OSError:
                pass  # already gone: pruning is best-effort

    def install_signal_handlers(self, signals: Sequence[int] = (_signal.SIGTERM, _signal.SIGINT)) -> None:
        """Arm the preemption flush: on a signal, write a final shard, then die."""
        for signum in signals:
            self._prev_handlers[signum] = _signal.getsignal(signum)
            _signal.signal(signum, self._on_signal)

    def uninstall_signal_handlers(self) -> None:
        for signum, prev in self._prev_handlers.items():
            _signal.signal(signum, prev)
        self._prev_handlers.clear()

    def _metric_mid_mutation(self) -> bool:
        """Whether the metric (or a collection member) is inside an update, a
        ``forward`` or a scan drain: a shard read then would be torn yet pass its CRC."""
        if getattr(self.metric, "_mutation_depth", 0):
            return True
        modules = getattr(self.metric, "_modules", None)
        if modules:
            return any(getattr(m, "_mutation_depth", 0) for m in modules.values())
        return False

    def preempt_flush(self, signum: int) -> Optional[str]:
        """The signal-time flush: a final shard, or None (standing on the last
        completed snapshot) when the signal landed inside an update."""
        if self._metric_mid_mutation():
            _diag.record(
                "snapshot.preempt", type(self.metric).__name__, signum=int(signum), seq=self._seq, skipped="mid-update"
            )
            return None
        path = self.flush(reason=f"signal:{signum}")
        _diag.record("snapshot.preempt", type(self.metric).__name__, signum=int(signum), seq=self._seq)
        return path

    def _on_signal(self, signum: int, frame: Any) -> None:
        try:
            self.preempt_flush(signum)
        finally:
            prev = self._prev_handlers.get(signum, _signal.SIG_DFL)
            _signal.signal(signum, prev if prev is not None else _signal.SIG_DFL)
            try:
                _signal.raise_signal(signum)
            finally:
                # a survivable delivery (a caught KeyboardInterrupt) leaves the flush
                # armed for the next signal; a fatal one never gets here
                if signum in self._prev_handlers:
                    _signal.signal(signum, self._on_signal)

    def __enter__(self) -> "ContinuousSnapshotter":
        self.install_signal_handlers()
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.uninstall_signal_handlers()


def restore_latest(metric: Any, directory: str, rank: int = 0, world_size: int = 1) -> int:
    """Restore the newest complete, integrity-clean snapshot sequence; returns its
    number. Incomplete, corrupt or version-mismatched sequences are skipped (each a
    ``snapshot.fallback`` event); ``SnapshotIntegrityError`` when none survives."""
    last_err: Optional[Exception] = None
    for seq, paths in reversed(list_snapshots(directory)):
        try:
            restore_resharded(metric, paths, rank=rank, world_size=world_size)
        except (SnapshotIntegrityError, SnapshotVersionError) as err:
            _diag.record(
                "snapshot.fallback", type(metric).__name__, seq=seq, error=type(err).__name__, detail=str(err)[:200]
            )
            last_err = err
            continue
        _diag.record("snapshot.restore_latest", type(metric).__name__, seq=seq, rank=int(rank))
        return seq
    if last_err is not None:
        raise SnapshotIntegrityError(
            f"no restorable snapshot sequence under {directory!r}: every candidate"
            " failed its integrity or version check"
        ) from last_err
    raise SnapshotIntegrityError(f"no snapshot sequences found under {directory!r}")
