"""Per-tenant metric slices in fixed memory (counterpart of
``torchmetrics_tpu/serve/tenancy.py``).

:class:`TenantSlices` holds one set of slotted states (``capacity`` rows per base
state) and routes every update by tenant id as data: the id is a tensor input, the
slot lookup is an open-addressing probe on the card, and the scatter lands in the
same step. So 10**4 distinct tenants share one captured graph.

When the table is full (or a probe chain is exhausted) the update spills: a dump row
at index ``capacity`` absorbs its contribution, which keeps :meth:`compute`'s global
value exact, and a built-in heavy-hitter sketch (``serve/sketch.py``'s states, flat on
this metric) keeps the spilled tenants' volume and the dominant ones.

Nothing in an update reads the host: the probe's ``argmax`` runs over an integer cast
of the match mask (``torch.argmax`` returns the first maximum, as JAX's does), and
each slot write is an ``index_put`` at a one-element index tensor. The per-tenant
views (:meth:`tenant_value` and the rest) are scrape-path reads through
``serve/snapshot.read_host``, never part of the update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.serve import stats as _serve_stats
from torchmetrics_tpu_torch.serve.sketch import (
    _CMS_SEEDS,
    _SEED_INDEX,
    _cms_add,
    _rank_zero_fold,
    canon_u32,
    canon_u32_host,
    hash_u32,
    hash_u32_host,
    merge_topk,
)
from torchmetrics_tpu_torch.serve.snapshot import read_host
from torchmetrics_tpu_torch.serve.window import (
    _ACROSS,
    capture_np_defaults,
    check_streamable,
    extract_contribution,
    run_base_compute,
)
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["TenantSlices", "federated_rollup"]


class TenantSlices(Metric):
    """Fixed-capacity per-tenant metric slices over one template metric.

    Args:
        template: the per-slice metric (sum / max / min states only: the
            :func:`~torchmetrics_tpu_torch.serve.window.check_streamable` algebra).
        capacity: tenant slots (a power of two; default
            ``TORCHMETRICS_TPU_SERVE_CAPACITY``, 4096).
        probes: linear-probe chain length per lookup.
        spill_k / spill_depth / spill_width: the over-capacity heavy-hitter sketch.

    ``update(tenant_id, *args)`` takes the tenant id as a 0-d integer tensor (a Python
    int works eagerly, but the engine captures only tensor inputs).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> from torchmetrics_tpu_torch.serve import TenantSlices
        >>> slices = TenantSlices(SumMetric(nan_strategy=0.0, device="cpu"), capacity=64)
        >>> slices.update(torch.tensor(7), torch.tensor(2.0))
        >>> slices.update(torch.tensor(9), torch.tensor(5.0))
        >>> slices.update(torch.tensor(7), torch.tensor(1.0))
        >>> float(slices.tenant_value(7)), float(slices.tenant_value(9))
        (3.0, 5.0)
    """

    _engine_traced_bodies = frozenset({"template"})
    full_state_update = True
    higher_is_better = None
    is_differentiable = False

    def __init__(
        self,
        template: Metric,
        capacity: Optional[int] = None,
        probes: int = 8,
        spill_k: int = 32,
        spill_depth: int = 4,
        spill_width: int = 2048,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", template.device)
        super().__init__(**kwargs)
        self._slot_folds = check_streamable(template, type(self).__name__)
        if capacity is None:
            capacity = _serve_stats.default_capacity()
        if not (isinstance(capacity, int) and capacity >= 2 and (capacity & (capacity - 1)) == 0):
            raise TorchMetricsUserError(f"Expected argument `capacity` to be a power-of-two int >= 2 but got {capacity}")
        if not (isinstance(probes, int) and probes >= 1):
            raise ValueError(f"Expected argument `probes` to be a positive int but got {probes}")
        self.template = template
        self.capacity = capacity
        self.probes = min(probes, capacity)
        self._base_keys = tuple(template._defaults)
        from torchmetrics_tpu_torch.engine.numerics import count_dtype

        idt = count_dtype()
        # slot table: -1 = empty; row `capacity` is the spill dump row
        self.add_state(
            "tenant_ids", default=torch.full((capacity + 1,), -1, dtype=idt),
            dist_reduce_fx=_rank_zero_fold, spec={"dtype_policy": "count"},
        )
        self.add_state(
            "tenant_counts", default=torch.zeros((capacity + 1,), dtype=idt),
            dist_reduce_fx="sum", spec={"dtype_policy": "count"},
        )
        for key in self._base_keys:
            default = template._defaults[key]
            slotted = default.unsqueeze(0).expand((capacity + 1,) + tuple(default.shape)).clone()
            self.add_state("seg_" + key, default=slotted, dist_reduce_fx=template._reductions[key])
        # spill accounting: the exact volume and the heavy-hitter sketch; the grid
        # precedes the adjacent (ids, counts) pair, as the packed hh fold requires
        self.add_state("spilled", default=torch.zeros((), dtype=idt), dist_reduce_fx="sum", spec={"dtype_policy": "count"})
        self.add_state(
            "spill_cms", default=torch.zeros((spill_depth, spill_width), dtype=idt),
            dist_reduce_fx="sum", spec={"role": "hh-grid", "dtype_policy": "count"},
        )
        self.add_state(
            "spill_ids", default=torch.full((spill_k,), -1, dtype=idt), dist_reduce_fx=_rank_zero_fold,
            spec={"role": "hh-ids", "hh": ("spill_cms", spill_k, spill_depth, spill_width), "dtype_policy": "count"},
        )
        self.add_state(
            "spill_counts", default=torch.zeros((spill_k,), dtype=idt), dist_reduce_fx=_rank_zero_fold,
            spec={"role": "hh-counts", "dtype_policy": "count"},
        )
        self._spill_geom = (spill_k, spill_depth, spill_width)
        self._np_defaults = capture_np_defaults(template, self._base_keys)
        _serve_stats.register_tenancy(self)

    def to(self, device: Any) -> "TenantSlices":
        """Move the states, the template and the kept defaults to ``device``."""
        super().to(device)
        self.template.to(device)
        self._np_defaults = {k: v.to(self.device) for k, v in self._np_defaults.items()}
        return self

    # ------------------------------------------------------------------ update

    def _lookup(self, table: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
        """The probe on the card: ``tid``'s slot, the first empty one on its chain, or
        ``capacity`` (spill). A 1-element int64 tensor."""
        h0 = hash_u32(canon_u32(tid), _SEED_INDEX)
        offsets = torch.arange(self.probes, dtype=torch.int64, device=table.device)
        idx = (h0 + offsets) & (self.capacity - 1)
        vals = table.index_select(0, idx)
        is_me = vals == tid
        is_empty = vals < 0
        found_slot = idx.index_select(0, torch.argmax(is_me.to(torch.int32)).reshape(1))
        empty_slot = idx.index_select(0, torch.argmax(is_empty.to(torch.int32)).reshape(1))
        return torch.where(is_me.any(), found_slot, torch.where(is_empty.any(), empty_slot, self.capacity))

    def update(self, tenant_id: Any, *args: Any, **kwargs: Any) -> None:
        """Fold one tenant's batch into its slice: the id is data, one graph.
        Spills past capacity land in the dump row and the heavy-hitter sketch."""
        tid = torch.as_tensor(tenant_id, device=self.device).to(self.tenant_ids.dtype).reshape(())
        contrib = extract_contribution(self.template, self._np_defaults, self._base_keys, type(self).__name__, args, kwargs)
        # a negative id would collide with the -1 empty-slot sentinel: it spills
        slot = torch.where(tid < 0, self.capacity, self._lookup(self.tenant_ids, tid))
        spilling = slot == self.capacity
        # claiming is idempotent for a found slot and harmless for the dump row
        self.tenant_ids = self.tenant_ids.index_put((slot,), tid.reshape(1))
        self.tenant_counts = self.tenant_counts.index_put((slot,), torch.ones_like(tid).reshape(1), accumulate=True)
        for key in self._base_keys:
            seg = getattr(self, "seg_" + key)
            kind, fold = self._slot_folds[key]
            row = contrib[key].unsqueeze(0)
            if kind == "sum":
                seg = seg.index_put((slot,), row, accumulate=True)
            else:
                seg = seg.index_put((slot,), fold(seg.index_select(0, slot), row))
            setattr(self, "seg_" + key, seg)
        # the spill path: a weight-0 scatter when not spilling keeps one graph for both
        self.spilled = self.spilled + spilling.to(self.spilled.dtype).reshape(())
        spill_k, spill_depth, spill_width = self._spill_geom
        w = spilling.to(self.spill_cms.dtype)
        cms = _cms_add(self.spill_cms, canon_u32(tid).reshape(1), w, spill_depth, spill_width)
        self.spill_cms = cms
        candidate = torch.where(spilling, tid, -1)
        self.spill_ids, self.spill_counts = merge_topk(
            cms, torch.cat([self.spill_ids, candidate]), spill_k, spill_depth, spill_width
        )

    # ------------------------------------------------------------------ compute

    def compute(self) -> Any:
        """The global value across every tenant (the dump row included: exact)."""
        folded = {key: _ACROSS[self._slot_folds[key][0]](getattr(self, "seg_" + key)) for key in self._base_keys}
        return run_base_compute(self.template, folded)

    # ------------------------------------------------------------------ views

    def _host_slot(self, tenant_id: int, table: Optional[np.ndarray] = None) -> Optional[int]:
        if int(tenant_id) < 0:
            return None  # negative ids spill, never slotted
        if table is None:
            table = read_host(self, ("tenant_ids",))["tenant_ids"]
        # host arithmetic, bit-equal to the device hash: a device dispatch and a
        # readback here would trip the strict guard when a scrape lands mid-stream
        h0 = hash_u32_host(canon_u32_host(tenant_id), _SEED_INDEX)
        for j in range(self.probes):
            idx = (h0 + j) & (self.capacity - 1)
            if table[idx] == int(tenant_id):
                return idx
            if table[idx] < 0:
                return None
        return None

    def tenant_value(self, tenant_id: int) -> Optional[Any]:
        """This tenant's computed value, or None when never tracked. A scrape-path
        read: one row per state crosses to the host through ``read_host``, and the
        template's raw compute runs over the slot's row."""
        slot = self._host_slot(tenant_id)
        if slot is None:
            return None
        rows = read_host(self, tuple("seg_" + k for k in self._base_keys), index=slot)
        states = {key: torch.as_tensor(rows["seg_" + key], device=self.device) for key in self._base_keys}
        return run_base_compute(self.template, states)

    def tenant_updates(self, tenant_id: int) -> int:
        """Updates this tenant has received (0 when untracked or spilled)."""
        if int(tenant_id) < 0:
            return 0
        host = read_host(self, ("tenant_ids", "tenant_counts"))
        slot = self._host_slot(tenant_id, table=host["tenant_ids"])
        return 0 if slot is None else int(host["tenant_counts"][slot])

    def tenant_count(self) -> int:
        """Live tracked tenants (a scrape-path host read)."""
        table = read_host(self, ("tenant_ids",))["tenant_ids"]
        return int((table[: self.capacity] >= 0).sum())

    def spilled_count(self) -> int:
        """Updates that spilled past capacity (a scrape-path host read)."""
        return int(read_host(self, ("spilled",))["spilled"])

    def spill_report(self) -> Dict[str, Any]:
        """The spilled volume and the dominant spilled tenants from the sketch."""
        host = read_host(self, ("spill_ids", "spill_counts", "spilled"))
        ids, counts, spilled = host["spill_ids"], host["spill_counts"], int(host["spilled"])
        live = ids >= 0
        return {
            "spilled_updates": spilled,
            "heavy_hitters": [
                {"tenant": int(i), "estimate": int(c)} for i, c in zip(ids[live].tolist(), counts[live].tolist())
            ],
        }


def _host_cms_estimate(cms: np.ndarray, tenant_id: int, width: int) -> int:
    """Host-mirror count-min query (bit-equal to the device hash chain)."""
    u = canon_u32_host(tenant_id)
    return int(min(int(cms[d][hash_u32_host(u, _CMS_SEEDS[d]) & (width - 1)]) for d in range(len(cms))))


def federated_rollup(slices: Any) -> Dict[str, Any]:
    """Global per-tenant rollup across pods' :class:`TenantSlices` views.

    Folds the slices by tenant id, not by slot (each pod's probe table chose its own
    slots), so tracked tenants stay exact across the fleet: each state by its
    sum / max / min algebra, the update counters summed. Spilled traffic reconciles
    approximately but accountably: the volumes sum, the grids sum, and every pod's
    spill candidates are estimated against the merged grid with the host-mirror hash.

    Returns ``{"tenants": {tid: {"value", "updates"}}, "spilled_updates",
    "heavy_hitters"}``, the heavy hitters ordered by estimate (desc), then id (asc).
    """
    slices = list(slices)
    if not slices:
        raise TorchMetricsUserError("federated_rollup needs at least one TenantSlices view to fold.")
    first = slices[0]
    base_keys = first._base_keys
    folds = first._slot_folds
    spill_k, spill_depth, spill_width = first._spill_geom
    for other in slices[1:]:
        if other._base_keys != base_keys or other._spill_geom != first._spill_geom:
            raise TorchMetricsUserError(
                "federated_rollup requires every pod's TenantSlices to share the"
                " template states and spill-sketch geometry — got mismatched"
                f" layouts ({base_keys} vs {other._base_keys})."
            )
    tenants: Dict[int, Dict[str, Any]] = {}
    spilled_total = 0
    cms_sum = np.zeros((spill_depth, spill_width), dtype=np.int64)
    candidates: set = set()
    for s in slices:
        host = read_host(
            s, ("tenant_ids", "tenant_counts", "spilled", "spill_cms", "spill_ids") + tuple("seg_" + k for k in base_keys)
        )
        table = host["tenant_ids"]
        counts = host["tenant_counts"]
        for slot in range(s.capacity):  # the dump row (index capacity) is spill
            tid = int(table[slot])
            if tid < 0:
                continue
            entry = tenants.get(tid)
            if entry is None:
                entry = tenants[tid] = {"updates": 0, "states": {key: None for key in base_keys}}
            entry["updates"] += int(counts[slot])
            for key in base_keys:
                row = np.asarray(host["seg_" + key][slot])
                prev = entry["states"][key]
                if prev is None:
                    entry["states"][key] = row
                else:
                    kind = folds[key][0]
                    entry["states"][key] = (
                        prev + row if kind == "sum" else np.maximum(prev, row) if kind == "max" else np.minimum(prev, row)
                    )
        spilled_total += int(host["spilled"])
        cms_sum += np.asarray(host["spill_cms"], dtype=np.int64)
        ids = np.asarray(host["spill_ids"])
        candidates.update(int(i) for i in ids[ids >= 0].tolist())
    out_tenants: Dict[int, Dict[str, Any]] = {}
    for tid in sorted(tenants):
        entry = tenants[tid]
        states = {key: torch.as_tensor(v, device=first.device) for key, v in entry["states"].items()}
        out_tenants[tid] = {"value": run_base_compute(first.template, states), "updates": entry["updates"]}
    hh = [{"tenant": tid, "estimate": _host_cms_estimate(cms_sum, tid, spill_width)} for tid in sorted(candidates)]
    hh.sort(key=lambda e: (-e["estimate"], e["tenant"]))
    return {"tenants": out_tenants, "spilled_updates": spilled_total, "heavy_hitters": hh[:spill_k]}
