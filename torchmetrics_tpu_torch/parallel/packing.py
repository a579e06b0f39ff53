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

Left out against the JAX plan: the divergence audit, the cross-rank timeline, the
degraded re-plan, sharded-state skips, the in-graph mesh exchange and sub-world
process groups (those take the eager path).
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torchmetrics_tpu_torch.engine.statespec import state_fold
from torchmetrics_tpu_torch.utilities.data import (
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["PackedSyncPlan", "PackingError", "all_gather_backbone", "shape_fingerprint"]

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


def all_gather_backbone(x: torch.Tensor) -> torch.Tensor:
    """One ``torch.distributed.all_gather`` of ``x`` over the default group, on ``x``'s
    own device: ``(world, *x.shape)``. Every rank passes a tensor of the same shape and
    dtype (the plan guarantees it)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return torch.stack(out)


class PackingError(Exception):
    """This state layout cannot ride the packed plan: fall back to the eager sync."""


class _Spec:
    """One state's slot in the packed buffers."""

    __slots__ = (
        "owner", "attr", "kind", "fold_fn", "dtype", "shape", "elem_shapes",
        "group", "offset", "size", "world_dim0", "pad_to", "needs_meta", "was_list", "packed_value",
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


class PackedSyncPlan:
    """Sync plan over one or more metrics' registered states.

    Usage (``engine/epoch.py`` drives it)::

        plan = PackedSyncPlan([(name, metric), ...], world_size)
        meta = plan.metadata_local()            # None when rank-invariant
        plan.finalize(world_meta)               # world_meta None when meta was
        local = plan.pack()                     # {buffer_key: flat tensor}
        gathered = {k: all_gather_backbone(v) for ...}  # one collective per buffer
        states = plan.make_fold()(gathered)     # {owner: {attr: synced value}}
    """

    def __init__(self, metrics: Sequence[Tuple[str, Any]], world_size: int) -> None:
        if world_size < 1:
            raise PackingError("world size < 1")
        self.world_size = int(world_size)
        self._metrics = list(metrics)
        self._finalized = False
        self._group_sizes: Dict[str, int] = {}
        self.specs: List[_Spec] = []
        self.empty_lists: List[Tuple[str, str]] = []  # cat / None lists empty on this rank
        self.device = self._metrics[0][1].device if self._metrics else torch.device("cpu")
        self._build()

    # ------------------------------------------------------------------ build

    def _build(self) -> None:
        from torchmetrics_tpu_torch.engine import numerics, txn

        for owner, metric in self._metrics:
            comp_names = numerics.comp_state_names(metric) if numerics.compensated_enabled() else ()
            if comp_names:
                numerics.ensure_residuals(metric)
            for attr in metric._reductions:
                val = getattr(metric, attr)
                default = metric._defaults[attr]
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
        if not entries:
            return None
        return np.asarray(entries, dtype=np.int32)

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
                    s.world_dim0 = tuple(int(c) for c in counts)
                    s.pad_to = int(counts.max())
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

    # ------------------------------------------------------------------ fold

    def signature(self) -> Tuple:
        """Cache key of the fold: the full static layout and the world size."""
        return (
            self.world_size,
            tuple(sorted(self._group_sizes.items())),
            tuple(
                (
                    s.owner, s.attr, s.kind, s.dtype, s.shape, s.elem_shapes,
                    s.group, s.offset, s.size, s.world_dim0, s.was_list, s.fold_fn,
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
        world = self.world_size
        residual_of = {(s.owner, s.attr): s for s in specs if s.kind == "comp-res"}

        def fold(gathered: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
            out: Dict[str, Dict[str, Any]] = {}
            for s in specs:
                dest = out.setdefault(s.owner, {})
                if s.kind == "comp-res":
                    continue  # folded with its value
                if s.kind in ("comp-sum", "comp-mean"):
                    # each rank's residual feeds back into its increment, the exact fold
                    # error carries forward, and the pair is re-anchored
                    rs = residual_of[(s.owner, s.attr)]
                    values = gathered[s.group][:, s.offset : s.offset + s.size].reshape((world,) + s.shape)
                    residuals = gathered[rs.group][:, rs.offset : rs.offset + rs.size].reshape((world,) + s.shape)
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
                seg = gathered[s.group][:, s.offset : s.offset + s.size]
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
