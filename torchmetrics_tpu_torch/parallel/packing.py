"""Packed state sync: the epoch-boundary communication plan.

Counterpart of ``torchmetrics_tpu/parallel/packing.py``. The eager sync
(``Metric._sync_dist``) issues one collective per state tensor, each behind its own
shape gather. A ``PackedSyncPlan`` bounds that:

1. **At most one metadata exchange**: one fixed-shape int32 ``all_gather`` carrying,
   for every dynamic state, its leading-dim size or element count plus a crc32 shape
   fingerprint. A plan whose states all keep their registered default's shape (the
   sum / mean / max / min case) is *rank-invariant* and skips it.
2. **One ``all_gather`` per (role, dtype) buffer**: sum- and mean-reduced states pack
   into a flat ``reduce:{dtype}`` buffer; max / min, ``None``-stacked tensors, custom
   folds, ragged ``cat`` states and list elements pack into ``gather:{dtype}``, ragged
   segments padded to the world's largest, known from the metadata.
3. **One fold**: ``make_fold`` returns a plain function of torch ops that unpacks the
   gathered ``(world, n)`` buffers and applies every state's fold. The caller caches
   it per ``signature()``.

A plan can span several metrics (a collection's compute-group owners), so a whole
collection syncs in O(dtypes) collectives. What the pack cannot express (list states
with a reduction other than ``cat`` / ``None``, states that are not tensors) raises
``PackingError`` at build and the caller takes the eager path, counted. Cross-rank
layouts that would deadlock the eager path (a ``cat`` list empty on some ranks only,
ragged ``None``-reduced lists, mismatched element shapes) fail loud from the metadata
on every rank with the eager guard's texts. The JAX package raises the empty-list
case only on the ranks whose list is empty; here every rank raises it, since every
rank sees the same metadata.

The riders ride the plan, their membership a function of the enablement knobs and
the metric's definition alone, so every rank lays out the same buffers (enable the
same modes on every rank): a compensated state (``engine/numerics.py``) packs its
residual right after its value in the same reduce buffer, and the fold chains the
ranks' (value, residual) pairs through two-sum, re-anchors, and returns the residual
under ``numerics.SYNC_RES_PREFIX + attr``; the quarantine counter (``engine/txn.py``)
sums in the reduce buffer.

The health sentinel (``diag/sentinel.py``) rides the plan too, as its own ``sentinel``
spec in the int32 gather buffer, folded by bitwise OR over the member rows (no
``torch.distributed`` reduce op computes it on a gather-then-fold plan, and the fold
stays capturable).

Two riders extend the int32 metadata row, each a function of its knob alone (enable it
on every rank): the divergence audit (``diag/sentinel.audit_context``) appends a
``(value fingerprint, element count)`` pair per fixed-shape state, read inside
``transfer_allowed("sync-audit")``, and ``finalize`` flags a rank-invariant state whose
fingerprints differ (``rank-invariant-divergence``) or float sums identical on every
rank (``duplicate-suspect``) in ``audit_results``; with profiling on
(``diag/profile.py``), the timeline triple ``[layout version, previous barrier exit,
arrival]`` (``diag/timeline.py``) goes last, the version is checked on every rank and
``timeline_result`` names the straggler. With the timeline on, the metadata gather runs
even for a rank-invariant plan, as in the JAX package. The arrival stamp is refreshed as
the rank enters the gather (``stamp_arrival_into``), after any planted delay.

A plan carries its live membership (``members``, every rank by default). The degraded
re-plan in ``engine/epoch.py`` builds a plan over the surviving ranks and marks it
``degraded`` with its ``excluded_ranks``: every rank of the world still takes part in
the one full-world ``all_gather`` per buffer (no sub-group is formed: on a live world
that would cost a collective and a barrier of its own), and the fold reads the member
rows alone. ``members`` is part of ``signature()``, so a degraded fold is never served
from the full world's cache entry.

Left out against the JAX plan: sharded-state skips, the in-graph mesh exchange and
sub-world process groups (those take the eager path).
"""

from __future__ import annotations

import functools
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.engine.statespec import state_fold, state_role
from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["PackedSyncPlan", "PackingError", "all_gather_backbone", "shape_fingerprint", "stamp_arrival_into"]

# each metadata entry is [count, shape fingerprint]
_META_INTS_PER_ENTRY = 2

_STACKED_FOLDS = {"sum": dim_zero_sum, "mean": dim_zero_mean, "max": dim_zero_max, "min": dim_zero_min}

_RAGGED_LIST_ERROR = (
    "Cannot sync list state `{attr}`: processes hold differing element counts {counts} — ranks with"
    " fewer elements would skip collectives the rest enter and deadlock the world. Ensure every"
    " process sees the same number of updates before compute(), or skip syncing"
    " (sync_on_compute=False) for ragged epochs."
)


def _dtype_name(dtype: torch.dtype) -> str:
    """``"int32"`` for ``torch.int32``: buffer keys read as the JAX package's do."""
    return str(dtype).removeprefix("torch.")


def shape_fingerprint(dims: Sequence[int]) -> int:
    """Process-stable digest of a dim sequence (crc32, masked to a positive int32)."""
    return zlib.crc32(np.asarray(list(dims), dtype=np.int64).tobytes()) & 0x7FFFFFFF


def stamp_arrival_into(meta: torch.Tensor) -> None:
    """Write this rank's arrival stamp (``diag/timeline``'s masked epoch clock) into the
    last slot of its metadata row, in place: the instant the rank enters the gather."""
    from torchmetrics_tpu_torch.diag import profile as _profile
    from torchmetrics_tpu_torch.diag.timeline import _MASK

    meta[-1].fill_(_profile.epoch_now_us() & _MASK)


def all_gather_backbone(
    x: torch.Tensor,
    label: str = "",
    members: Optional[Sequence[int]] = None,
    on_enter: Optional[Callable[[torch.Tensor], None]] = None,
) -> torch.Tensor:
    """One ``torch.distributed.all_gather`` of ``x`` over the default group, on ``x``'s
    own device: ``(world, *x.shape)``. Every rank passes a tensor of the same shape and
    dtype (the plan guarantees it).

    The collective rides ``parallel/resilience.bounded_collective`` under ``label``
    (the plan's buffer key, or ``"meta"``) with the plan's live ``members``, which the
    fault harness and ``verify_payload`` consult, inside the sanctioned
    ``transfer_allowed("collective:<label>")`` boundary; each call is a ``collective``
    event. ``on_enter(x)`` runs as the rank enters the collective (the timeline's
    arrival stamp).
    """
    from torchmetrics_tpu_torch.diag import trace as _diag
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed
    from torchmetrics_tpu_torch.parallel import sync as _sync
    from torchmetrics_tpu_torch.parallel.resilience import bounded_collective

    x = x.contiguous()
    _diag.record("collective", "", label=label, bytes=int(x.nbytes))
    with transfer_allowed("collective:" + label):
        rows = bounded_collective(
            lambda t: _sync.raw_all_gather(t), label=label, payload=x, members=members,
            on_enter=None if on_enter is None else (lambda: on_enter(x)),
        )
    return rows if isinstance(rows, torch.Tensor) else torch.stack(rows)


class PackingError(Exception):
    """This state layout cannot ride the packed plan: fall back to the eager sync."""


def _check_hh_layout(metric: Any) -> None:
    """A heavy-hitter pair (``serve/sketch.py``) folds jointly against the merged
    count-min grid: the grid must be registered before the pair, and the counts right
    after the ids. Membership is a function of the metric's definition, so every rank
    lays out the same plan."""
    names = list(metric._reductions)
    ids_attr = next((n for n in names if state_role(metric, n) == "hh-ids"), None)
    counts_attr = next((n for n in names if state_role(metric, n) == "hh-counts"), None)
    if ids_attr is None:
        if counts_attr is not None:
            raise PackingError(
                f"state {counts_attr!r} declares role 'hh-counts' with no paired 'hh-ids' state — the"
                " heavy-hitter pair folds jointly"
            )
        return
    grid_attr = metric._state_roles[ids_attr]["hh"][0]
    if (
        grid_attr not in names
        or counts_attr is None
        or names.index(grid_attr) > names.index(ids_attr)
        or names.index(counts_attr) != names.index(ids_attr) + 1
    ):
        raise PackingError(
            "heavy-hitter fold requires the count-min grid registered before the adjacent (ids, counts) top-k pair"
        )


def _snapshot_cat_array(value: Any) -> Optional[np.ndarray]:
    """A snapshot's cat state as one host array (a list concatenated), or None when
    empty."""
    if isinstance(value, (list, tuple)):
        if not value:
            return None
        arr = np.concatenate([np.atleast_1d(np.asarray(e.cpu() if isinstance(e, torch.Tensor) else e)) for e in value])
    else:
        if value is None:
            return None
        arr = np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value)
    return arr.reshape(1) if arr.ndim == 0 else arr


class _Spec:
    """One state's slot in the packed buffers."""

    __slots__ = (
        "owner", "attr", "kind", "fold_fn", "dtype", "shape", "elem_shapes",
        "group", "offset", "size", "world_dim0", "pad_to", "needs_meta", "was_list", "packed_value",
        "rank_invariant", "hh_meta",
    )

    def __init__(self, owner: str, attr: str, kind: str, dtype: str, fold_fn: Optional[Callable] = None):
        self.owner = owner
        self.attr = attr
        self.kind = kind  # sum | mean | max | min | none-array | custom | cat | none-list
        self.fold_fn = fold_fn  # custom folds only
        self.dtype = dtype
        self.shape: Tuple[int, ...] = ()
        self.elem_shapes: Tuple[Tuple[int, ...], ...] = ()  # none-list only
        self.group = ""
        self.offset = 0
        self.size = 0  # flat length of this spec's segment (ragged padding included)
        self.world_dim0: Tuple[int, ...] = ()  # cat only: every rank's true dim 0
        self.pad_to = 0  # cat only: the world's largest dim 0
        self.needs_meta = False
        self.was_list = False
        self.packed_value: Optional[torch.Tensor] = None  # cat lists: concatenated once at build
        self.rank_invariant = False  # audit: the values must match on every rank
        self.hh_meta: Optional[Tuple[str, int, int, int]] = None  # hh-ids: (grid attr, k, depth, width)


class PackedSyncPlan:
    """Sync plan over one or more metrics' registered states.

    Usage (``engine/epoch.py`` drives it)::

        plan = PackedSyncPlan([(name, metric), ...], world_size)   # members: every rank
        meta = plan.metadata_local()            # None when rank-invariant
        plan.finalize(world_meta)               # world_meta None when meta was
        local = plan.pack()                     # {buffer_key: flat tensor}
        gathered = {k: all_gather_backbone(v) for ...}  # one collective per buffer
        states = plan.make_fold()(gathered)     # {owner: {attr: synced value}}
    """

    def __init__(
        self, metrics: Sequence[Tuple[str, Any]], world_size: int, members: Optional[Sequence[int]] = None
    ) -> None:
        if world_size < 1:
            raise PackingError("world size < 1")
        self.world_size = int(world_size)
        self.members: Tuple[int, ...] = (
            tuple(range(self.world_size)) if members is None else tuple(int(i) for i in members)
        )
        # set by the degraded re-plan (engine/epoch.py): a fold over fewer ranks than
        # the world is never silent (EngineStats.sync_degraded_folds, sync.degraded)
        self.degraded = False
        self.excluded_ranks: Tuple[int, ...] = ()
        # set by the degraded re-plan after an in-flight escape left the group out of
        # step: the exchange issues no collective and folds this rank's own rows
        self.local_only = False
        # the divergence audit and the timeline (diag/): frozen at build, a function of
        # the knobs and the world size alone, so every rank lays out the same row
        from torchmetrics_tpu_torch.diag import profile as _profile
        from torchmetrics_tpu_torch.diag import sentinel as _sentinel

        self.audit = _sentinel.audit_enabled() and self.world_size > 1
        self.audit_results: List[Dict[str, Any]] = []
        self._audit_nonzero: List[bool] = []  # the local any() per audited spec
        self.timeline = _profile.timeline_enabled() and self.world_size > 1
        self.timeline_result: Optional[Dict[str, Any]] = None
        self._metrics = list(metrics)
        self._finalized = False
        self._group_sizes: Dict[str, int] = {}
        self.specs: List[_Spec] = []
        self.empty_lists: List[Tuple[str, str]] = []  # cat / None lists empty on this rank
        self.device = self._metrics[0][1].device if self._metrics else torch.device("cpu")
        self._build()

    # ------------------------------------------------------------------ build

    def _build(self) -> None:
        from torchmetrics_tpu_torch.diag import sentinel
        from torchmetrics_tpu_torch.engine import numerics, txn

        for owner, metric in self._metrics:
            rank_invariant = getattr(metric, "_rank_invariant_states", ()) or ()
            comp_names = numerics.comp_state_names(metric) if numerics.compensated_enabled() else ()
            if comp_names:
                numerics.ensure_residuals(metric)
            _check_hh_layout(metric)
            for attr in metric._reductions:
                val = getattr(metric, attr)
                default = metric._defaults[attr]
                role = state_role(metric, attr)
                if role in ("hh-ids", "hh-counts"):
                    # the heavy-hitter pair folds jointly against the merged grid
                    if not isinstance(val, torch.Tensor):
                        raise PackingError(f"heavy-hitter state {attr!r} is not a tensor")
                    spec = _Spec(owner, attr, role, _dtype_name(val.dtype))
                    spec.shape = tuple(int(d) for d in val.shape)
                    spec.size = int(np.prod(spec.shape, dtype=np.int64)) if spec.shape else 1
                    spec.needs_meta = tuple(default.shape) != spec.shape
                    spec.group = "gather:" + spec.dtype
                    if role == "hh-ids":
                        spec.hh_meta = tuple(metric._state_roles[attr]["hh"])
                    self.specs.append(spec)
                    continue
                fold, fold_fn = state_fold(metric, attr)
                if isinstance(default, list):
                    if fold not in ("cat", "none"):
                        raise PackingError(f"list state {attr!r} with non-cat reduction")
                    self._add_list_spec(owner, attr, fold, val)
                    continue
                if not isinstance(val, torch.Tensor):
                    raise PackingError(f"state {attr!r} is not a tensor")
                kind = {"none": "none-array"}.get(fold, fold)
                spec = _Spec(owner, attr, kind, _dtype_name(val.dtype), fold_fn)
                spec.rank_invariant = attr in rank_invariant
                spec.shape = tuple(int(d) for d in val.shape)
                spec.size = int(np.prod(spec.shape, dtype=np.int64)) if spec.shape else 1
                if kind == "cat":
                    # dim 0 may differ per rank; trailing dims must agree
                    if not spec.shape:
                        spec.shape, spec.size = (1,), 1
                    spec.needs_meta = True
                else:
                    # non-cat folds need equal shapes on every rank; a state that has
                    # drifted from its default's shape gets a verification entry
                    spec.needs_meta = tuple(default.shape) != spec.shape
                spec.group = ("reduce:" if kind in ("sum", "mean") else "gather:") + spec.dtype
                self.specs.append(spec)
                if attr in comp_names and kind in ("sum", "mean"):
                    # the (value, residual) pair folds by two-sum: the residual rides
                    # the same buffer right after its value
                    spec.kind = "comp-" + kind
                    res = _Spec(owner, attr, "comp-res", spec.dtype)
                    res.shape, res.size, res.group = spec.shape, spec.size, spec.group
                    self.specs.append(res)
            if sentinel.sentinel_enabled():
                # the bitmask folds by OR: a flag raised on any rank survives the sync
                flags = sentinel.ensure_flags(metric)
                spec = _Spec(owner, sentinel.ATTR, "sentinel", _dtype_name(flags.dtype))
                spec.shape, spec.size = tuple(flags.shape), 1
                spec.group = "gather:" + spec.dtype
                self.specs.append(spec)
            if txn.quarantine_enabled():
                count = txn.ensure_count(metric)
                spec = _Spec(owner, txn.ATTR, "sum", _dtype_name(count.dtype))
                spec.shape, spec.size = tuple(count.shape), 1
                spec.group = "reduce:" + spec.dtype
                self.specs.append(spec)

    def _add_list_spec(self, owner: str, attr: str, fold: str, val: Any) -> None:
        elements = val if isinstance(val, list) else [val]
        if not all(isinstance(x, torch.Tensor) for x in elements):
            raise PackingError(f"list state {attr!r} holds host objects")
        if fold == "cat":
            spec = _Spec(owner, attr, "cat", "")
            spec.needs_meta = True
            spec.was_list = True
            if not elements:
                # a zero-row metadata entry, so mixed emptiness across ranks fails loud
                self.empty_lists.append((owner, attr))
                spec.shape = (0,)
                self.specs.append(spec)
                return
            cat = dim_zero_cat(elements)
            spec.dtype = _dtype_name(cat.dtype)
            spec.shape = tuple(int(d) for d in cat.shape)
            spec.size = int(np.prod(spec.shape, dtype=np.int64))
            spec.packed_value = cat  # concatenated once; pack() reuses it
            spec.group = "gather:" + spec.dtype
            self.specs.append(spec)
            return
        # None-reduced list: positional per-element semantics, equal counts and
        # per-position shapes required on every rank (the eager guard's rule)
        spec = _Spec(owner, attr, "none-list", _dtype_name(elements[0].dtype) if elements else "")
        if any(_dtype_name(e.dtype) != spec.dtype for e in elements):
            raise PackingError(f"list state {attr!r} mixes element dtypes")
        spec.elem_shapes = tuple(tuple(int(d) for d in e.shape) for e in elements)
        spec.size = int(sum(np.prod(s, dtype=np.int64) if s else 1 for s in spec.elem_shapes))
        spec.needs_meta = True
        spec.was_list = True
        if elements:
            spec.group = "gather:" + spec.dtype
        self.specs.append(spec)

    # ------------------------------------------------------------------ metadata

    @property
    def rank_invariant(self) -> bool:
        """True when every shape is provably identical on all ranks: the metadata
        exchange is skipped (zero extra collectives)."""
        return not any(s.needs_meta for s in self.specs)

    def metadata_local(self) -> Optional[np.ndarray]:
        """This rank's fixed-shape int32 probe covering every dynamic state, or ``None``."""
        entries: List[int] = []
        for s in self.specs:
            if not s.needs_meta:
                continue
            if s.kind == "cat":
                dim0 = s.shape[0] if s.size else 0
                entries += [dim0, shape_fingerprint(s.shape[1:]) if s.size else 0]
            elif s.kind == "none-list":
                dims: List[int] = []
                for es in s.elem_shapes:
                    dims.append(len(es))
                    dims.extend(es)
                entries += [len(s.elem_shapes), shape_fingerprint(dims)]
            else:  # static-shape verification entry
                entries += [s.size, shape_fingerprint(s.shape)]
        if self.audit:
            from torchmetrics_tpu_torch.diag.sentinel import value_fingerprint
            from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

            by_owner = dict(self._metrics)
            self._audit_nonzero = []
            with transfer_allowed("sync-audit"):
                for s in self._audit_specs():
                    crc, count, nonzero = value_fingerprint(getattr(by_owner[s.owner], s.attr))
                    self._audit_nonzero.append(nonzero)
                    entries += [crc, count]
        if self.timeline:
            from torchmetrics_tpu_torch.diag.timeline import timeline_entries

            # [layout version, previous barrier exit, arrival], last
            entries += timeline_entries()
        if not entries:
            return None
        return np.asarray(entries, dtype=np.int32)

    #: spec kinds the divergence audit fingerprints (fixed-shape array states; cat and
    #: list states are ragged by design and the sentinel is already ORed)
    _AUDITABLE = ("sum", "mean", "max", "min", "none-array", "custom")

    def _audit_specs(self) -> List[_Spec]:
        return [s for s in self.specs if s.kind in self._AUDITABLE]

    @staticmethod
    def _local_rank() -> int:
        import torch.distributed as dist

        return int(dist.get_rank()) if dist.is_available() and dist.is_initialized() else 0

    def finalize(self, world_meta: Optional[np.ndarray]) -> None:
        """Validate the exchanged metadata and freeze buffer offsets.

        ``world_meta`` is the gathered ``(world, n_entries)`` probe (``None`` when
        ``metadata_local`` returned ``None``). Raises ``TorchMetricsUserError`` for
        layouts that would deadlock or corrupt the sync, on every rank alike, since
        every rank sees the same world metadata.
        """
        if world_meta is not None:
            world_meta = np.asarray(world_meta)
            idx = 0
            for s in self.specs:
                if not s.needs_meta:
                    continue
                counts = world_meta[:, idx]
                prints = world_meta[:, idx + 1]
                idx += _META_INTS_PER_ENTRY
                if s.kind == "cat":
                    if s.was_list and counts.max() > 0 and counts.min() == 0:
                        # an empty list knows no dtype, so its rank cannot lay out the
                        # buffer the others gather
                        raise TorchMetricsUserError(_RAGGED_LIST_ERROR.format(attr=s.attr, counts=counts.tolist()))
                    nonzero = prints[counts > 0]
                    if nonzero.size and nonzero.max() != nonzero.min():
                        raise TorchMetricsUserError(
                            f"Cannot sync state `{s.attr}`: processes hold mismatched trailing shapes for the"
                            f" cat-reduced state (shape fingerprints {prints.tolist()})."
                        )
                    s.world_dim0 = tuple(int(counts[i]) for i in self.members)
                    s.pad_to = int(counts.max())  # non-members pack the collective too
                elif s.kind == "none-list":
                    if counts.max() != counts.min():
                        raise TorchMetricsUserError(_RAGGED_LIST_ERROR.format(attr=s.attr, counts=counts.tolist()))
                    if counts.max() > 0 and prints.max() != prints.min():
                        raise TorchMetricsUserError(
                            f"Cannot sync list state `{s.attr}`: processes hold equal element counts but"
                            f" mismatched per-element shapes (shape fingerprints {prints.tolist()}). Positional"
                            " collectives over a None-reduced list state require identical per-position"
                            " shapes on every rank."
                        )
                elif counts.max() != counts.min() or prints.max() != prints.min():
                    raise TorchMetricsUserError(
                        f"Cannot sync state `{s.attr}`: processes hold mismatched shapes (sizes"
                        f" {counts.tolist()}, fingerprints {prints.tolist()}); non-cat reductions require"
                        " identical state shapes on every rank."
                    )
            if self.audit:
                idx = self._finalize_audit(world_meta, idx)
            if self.timeline:
                self._finalize_timeline(world_meta, idx)
        # pad ragged cat segments to the world's largest and freeze offsets
        offsets: Dict[str, int] = {}
        for s in self.specs:
            if s.kind == "cat" and s.pad_to:
                trailing = int(np.prod(s.shape[1:], dtype=np.int64)) if len(s.shape) > 1 else 1
                s.size = s.pad_to * trailing
            if not s.group:
                continue
            s.offset = offsets.get(s.group, 0)
            offsets[s.group] = s.offset + s.size
        self._group_sizes = dict(offsets)
        self._finalized = True

    def _finalize_audit(self, world_meta: np.ndarray, idx: int) -> int:
        """Compare every fixed-shape state's value fingerprint across ranks before the
        fold hides the per-rank view. Divergence is normal for accumulating states and is
        flagged only for those declared rank-invariant; identical nonzero float sums on
        every rank are the opposite smell (each rank saw the same stream, the fold will
        double-count), reported as ``duplicate-suspect``. Integer counts are exempt:
        balanced sharding gives equal counts legitimately."""
        self.audit_results = []
        for i, s in enumerate(self._audit_specs()):
            fps = world_meta[:, idx]
            sizes = world_meta[:, idx + 1]
            idx += _META_INTS_PER_ENTRY
            divergent = bool(fps.max() != fps.min() or sizes.max() != sizes.min())
            local_nonzero = i < len(self._audit_nonzero) and self._audit_nonzero[i]
            if divergent and s.rank_invariant:
                flag = "rank-invariant-divergence"
            elif not divergent and local_nonzero and s.kind in ("sum", "mean") and s.dtype.startswith(("float", "bfloat")):
                flag = "duplicate-suspect"
            else:
                flag = ""
            self.audit_results.append(
                {"owner": s.owner, "attr": s.attr, "kind": s.kind, "divergent": divergent, "flag": flag}
            )
        return idx

    def _finalize_timeline(self, world_meta: np.ndarray, idx: int) -> None:
        """Check the timeline layout version on every rank (asymmetric profiling would
        mis-parse the row: it fails loud everywhere) and resolve the arrivals."""
        from torchmetrics_tpu_torch.diag import timeline

        versions = world_meta[:, idx]
        if int(versions.max()) != int(versions.min()) or int(versions.max()) != timeline.LAYOUT_VERSION:
            raise TorchMetricsUserError(
                f"Cannot sync: processes disagree on the packed-sync timeline layout (versions"
                f" {versions.tolist()}, expected {timeline.LAYOUT_VERSION}). Profiling"
                " (TORCHMETRICS_TPU_PROFILE / profile_context) extends the metadata layout and must"
                " be enabled on every rank or none."
            )
        self.timeline_result = timeline.resolve_arrivals(world_meta[:, idx + 1], world_meta[:, idx + 2], self._local_rank())

    def coverage(self) -> Dict[str, Any]:
        """What a value folded through this plan covers: the members, the ranks a
        degraded re-plan excluded (reason ``sync-fault``) and whether the fold covered
        the full world (the lineage coverage stamp's shape)."""
        return {
            "members": [str(r) for r in self.members],
            "world_size": self.world_size,
            "degraded": self.degraded,
            "excluded": [{"id": str(r), "reason": "sync-fault"} for r in self.excluded_ranks],
            "complete": not self.degraded and len(self.members) == self.world_size,
        }

    # ------------------------------------------------------------------ pack

    def buffer_keys(self) -> List[str]:
        return sorted(self._group_sizes)

    def pack(self) -> Dict[str, torch.Tensor]:
        """Concatenate every local state into its flat per-(role, dtype) buffer."""
        if not self._finalized:
            raise RuntimeError("finalize() must run before pack()")
        from torchmetrics_tpu_torch.engine import numerics

        segments: Dict[str, List[torch.Tensor]] = {k: [] for k in self._group_sizes}
        by_owner = dict(self._metrics)
        for s in self.specs:
            if not s.group or s.size == 0:
                continue
            if s.kind == "comp-res":
                val = numerics.ensure_residuals(by_owner[s.owner])[s.attr]
            else:
                val = getattr(by_owner[s.owner], s.attr)
            if s.kind == "none-list":
                flat = torch.cat([e.reshape(-1) for e in val])
            elif s.kind == "cat":
                flat = (s.packed_value if s.was_list else val).reshape(-1)
                if flat.numel() < s.size:  # ragged: pad to the world's largest
                    flat = torch.nn.functional.pad(flat, (0, s.size - flat.numel()))
            else:
                flat = val.reshape(-1)
            segments[s.group].append(flat)
        return {k: torch.cat(v) for k, v in segments.items() if v}

    def metadata_from_state(self, states: Dict[str, Dict[str, Any]]) -> Optional[np.ndarray]:
        """``metadata_local`` computed from a snapshot ``{owner: {attr: value}}``
        instead of the live metrics: the federation aggregator (``serve/federation.py``)
        folds pod snapshots. The entry layout is ``metadata_local``'s with the audit
        and timeline riders off (the aggregation tier turns both off on its plan)."""
        entries: List[int] = []
        for s in self.specs:
            if not s.needs_meta:
                continue
            value = states.get(s.owner, {}).get(s.attr)
            if s.kind == "cat":
                arr = _snapshot_cat_array(value)
                if arr is None or arr.size == 0:
                    entries += [0, 0]
                else:
                    entries += [int(arr.shape[0]), shape_fingerprint(arr.shape[1:])]
            elif s.kind == "none-list":
                elems = value if isinstance(value, (list, tuple)) else []
                dims: List[int] = []
                for e in elems:
                    es = tuple(np.shape(e))
                    dims.append(len(es))
                    dims.extend(es)
                entries += [len(elems), shape_fingerprint(dims)]
            else:  # static-shape verification entry
                shape = tuple(np.shape(value))
                size = int(np.prod(shape, dtype=np.int64)) if shape else 1
                entries += [size, shape_fingerprint(shape)]
        if not entries:
            return None
        return np.asarray(entries, dtype=np.int32)

    def pack_from(
        self, states: Dict[str, Dict[str, Any]], residuals: Optional[Dict[str, Dict[str, Any]]] = None
    ) -> Dict[str, torch.Tensor]:
        """``pack`` over a snapshot ``{owner: {attr: value}}`` (host arrays or tensors)
        instead of the live metrics, onto the plan's device: each pod's verified
        snapshot packs into the buffers ``make_fold`` takes. ``residuals`` gives the
        compensated residuals per ``{owner: {attr: residual}}``; an absent one packs
        as zeros (the pod's value folds as a clean anchor)."""
        if not self._finalized:
            raise RuntimeError("finalize() must run before pack_from()")
        residuals = residuals or {}
        segments: Dict[str, List[torch.Tensor]] = {k: [] for k in self._group_sizes}

        def flat(value: Any, dtype: str) -> torch.Tensor:
            return torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value).to(
                device=self.device, dtype=getattr(torch, dtype)
            ).reshape(-1)

        for s in self.specs:
            if not s.group or s.size == 0:
                continue
            if s.kind == "comp-res":
                val = residuals.get(s.owner, {}).get(s.attr)
                seg = torch.zeros(s.size, dtype=getattr(torch, s.dtype), device=self.device) if val is None else flat(val, s.dtype)
            else:
                val = states.get(s.owner, {}).get(s.attr)
                if s.kind == "none-list":
                    seg = torch.cat([flat(e, s.dtype) for e in val])
                elif s.kind == "cat":
                    arr = _snapshot_cat_array(val)
                    seg = torch.zeros(0, dtype=getattr(torch, s.dtype), device=self.device) if arr is None else flat(arr, s.dtype)
                    if seg.numel() < s.size:  # ragged: pad to the world's largest
                        seg = torch.nn.functional.pad(seg, (0, s.size - seg.numel()))
                else:
                    seg = flat(val, s.dtype)
            segments[s.group].append(seg)
        return {k: torch.cat(v) for k, v in segments.items() if v}

    # ------------------------------------------------------------------ fold

    def signature(self) -> Tuple:
        """Cache key of the fold: the full static layout, the world size and the members."""
        return (
            self.world_size,
            self.members,
            tuple(sorted(self._group_sizes.items())),
            tuple(
                (
                    s.owner, s.attr, s.kind, s.dtype, s.shape, s.elem_shapes,
                    s.group, s.offset, s.size, s.world_dim0, s.was_list, s.fold_fn, s.hh_meta,
                )
                for s in self.specs
            ),
            tuple(self.empty_lists),
        )

    def make_fold(self) -> Callable[[Dict[str, torch.Tensor]], Dict[str, Dict[str, Any]]]:
        """Plain ``gathered buffers -> {owner: {attr: synced value}}`` function.

        Every slice boundary is a Python int of the plan, so the function holds no
        reference to any metric and can be cached per ``signature()``.
        """
        if not self._finalized:
            raise RuntimeError("finalize() must run before make_fold()")
        from torchmetrics_tpu_torch.engine import numerics

        specs = list(self.specs)
        empty = list(self.empty_lists)
        members = list(self.members)
        world = len(members)
        residual_of = {(s.owner, s.attr): s for s in specs if s.kind == "comp-res"}
        # the hh-counts spec registered right after its hh-ids (checked at build)
        counts_of = {i: specs[i + 1] for i, s in enumerate(specs) if s.kind == "hh-ids"}

        def rows(buf: torch.Tensor, s: _Spec) -> torch.Tensor:
            """The member rows of ``s``'s segment: a degraded plan slices the
            survivors' rows (slices, so a captured fold needs no index upload)."""
            seg = buf[:, s.offset : s.offset + s.size]
            if members == list(range(buf.shape[0])):
                return seg
            return torch.cat([seg[r : r + 1] for r in members])

        def fold(gathered: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
            out: Dict[str, Dict[str, Any]] = {}
            for i, s in enumerate(specs):
                dest = out.setdefault(s.owner, {})
                if s.kind in ("comp-res", "hh-counts"):
                    continue  # folded with its value / its hh-ids spec
                if s.kind == "hh-ids":
                    # the union of every member's candidates, estimated against the
                    # merged grid this fold already summed (the grid's spec comes first)
                    from torchmetrics_tpu_torch.serve.sketch import merge_topk

                    grid_attr, k, depth, width = s.hh_meta
                    ids, counts = merge_topk(dest[grid_attr], rows(gathered[s.group], s).reshape(-1), k, depth, width)
                    dest[s.attr] = ids.to(getattr(torch, s.dtype))
                    cs = counts_of[i]
                    dest[cs.attr] = counts.to(getattr(torch, cs.dtype))
                    continue
                if s.kind in ("comp-sum", "comp-mean"):
                    # each rank's residual feeds back into its increment, the exact fold
                    # error carries forward, and the pair is re-anchored
                    rs = residual_of[(s.owner, s.attr)]
                    values = rows(gathered[s.group], s).reshape((world,) + s.shape)
                    residuals = rows(gathered[rs.group], rs).reshape((world,) + s.shape)
                    total, res = values[0], residuals[0]
                    for r in range(1, world):
                        total, res = numerics.two_sum(total, values[r] + residuals[r] + res)
                    total, res = numerics.two_sum(total, res)
                    if s.kind == "comp-mean":
                        total, res = total / world, res / world
                    dest[s.attr] = total
                    dest[numerics.SYNC_RES_PREFIX + s.attr] = res
                    continue
                if s.kind == "cat" and (not s.group or max(s.world_dim0, default=1) == 0):
                    # empty on every rank: lists stay [], tensors keep a 0-row shape
                    dest[s.attr] = (
                        [] if s.was_list or not s.group else gathered[s.group].new_zeros((0,) + s.shape[1:])
                    )
                    continue
                if s.kind == "none-list" and not s.elem_shapes:
                    dest[s.attr] = []
                    continue
                seg = rows(gathered[s.group], s)
                if s.kind == "sentinel":
                    # per-bit max is bitwise OR: a flag raised on any rank survives
                    dest[s.attr] = functools.reduce(torch.bitwise_or, [seg[r] for r in range(world)]).reshape(s.shape)
                    continue
                if s.kind in _STACKED_FOLDS:
                    dest[s.attr] = _STACKED_FOLDS[s.kind](seg.reshape((world,) + s.shape))
                elif s.kind == "none-array":
                    dest[s.attr] = seg.reshape((world,) + s.shape)
                elif s.kind == "custom":
                    dest[s.attr] = s.fold_fn(seg.reshape((world,) + s.shape))
                elif s.kind == "cat":
                    trailing = s.shape[1:]
                    tsize = int(np.prod(trailing, dtype=np.int64)) if trailing else 1
                    dims = s.world_dim0 or (s.shape[0],) * world
                    parts = [seg[r, : dims[r] * tsize].reshape((dims[r],) + trailing) for r in range(world) if dims[r]]
                    dest[s.attr] = torch.cat(parts, dim=0)
                else:  # none-list: element-major interleave, the eager path's order
                    elems: List[torch.Tensor] = []
                    off = 0
                    for es in s.elem_shapes:
                        esize = int(np.prod(es, dtype=np.int64)) if es else 1
                        elems.extend(seg[r, off : off + esize].reshape(es) for r in range(world))
                        off += esize
                    dest[s.attr] = elems
            for owner, attr in empty:
                out.setdefault(owner, {}).setdefault(attr, [])
            return out

        return fold

    def none_folded_attrs(self, owner: str) -> List[str]:
        """Attrs whose synced value carries a new leading shard axis."""
        return [s.attr for s in self.specs if s.owner == owner and s.kind == "none-array"]
