"""Collection-level dispatch fusion (counterpart of ``torchmetrics_tpu/engine/fusion.py``).

A ``MetricCollection`` step over N compute-group owners costs N engine steps even
when every owner runs its own graph. ``FusedUpdate`` captures every fusable owner's
update into ONE CUDA graph per signature, over static state buffers per member, so
the N-metric step is one batch copy and one replay. It is ``GraphEngine``
(``engine/compiled.py``) over the owners, with at least two of them per signature.

Members that cannot fuse (list states, a ``compiled_update=False`` opt-out, an update
the guard refuses at the signature's first step: host validation, side effects) are
excluded and reported back to the caller, which updates them eagerly; one bad metric
never un-fuses the rest. Shape bucketing applies when every eligible member supports
the pad-subtract identity (``engine/bucketing.py``).

Each member carries its own riders (``engine/compiled.py``: the sentinel fold, the
quarantine transaction and the compensated two-sum, the JAX ``build_fused_riders``)
inside the one graph. A step records the ``fused.*`` events and histograms
(``GraphEngine.kind``), and a guard refusal a ``fused.exclude`` event.
``scan_step`` queues the step on the engine's ``FusedScan`` (``engine/scan.py``); a
drain calls ``on_scan_drain`` (the collection re-anchors its views).

Left out against the JAX engine: ``persist``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import torch

from torchmetrics_tpu_torch.engine.compiled import GraphEngine, structural_refusal


class FusedUpdate(GraphEngine):
    """One captured graph updating several metrics' states per step."""

    min_members = 2
    kind = "fused"

    def __init__(self, metrics: Sequence[Tuple[str, Any]]) -> None:
        self.metrics: List[Tuple[str, Any]] = list(metrics)
        super().__init__("fused:" + ",".join(type(m).__name__ for _, m in self.metrics))
        self._member_ok: Dict[str, bool] = {}  # structural eligibility, frozen on first sight
        self.on_scan_drain: Optional[Callable[[], None]] = None  # set by the owning collection

    def eligible_members(self) -> List[Tuple[str, Any]]:
        """The members structurally able to fuse right now (opt-outs honored)."""
        members: List[Tuple[str, Any]] = []
        for name, m in self.metrics:
            if m.compiled_update is False:  # the per-metric opt-out outranks fusion
                continue
            ok = self._member_ok.get(name)
            if ok is None:
                ok = self._member_ok[name] = structural_refusal(m) is None
            if ok and all(isinstance(getattr(m, k), torch.Tensor) for k in m._defaults):
                members.append((name, m))
        return members

    def step(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Set[str]:
        """Run one fused step; returns the names of the members it updated.

        An empty set means nothing was fused: the caller runs every member itself. A
        non-empty result may still omit members (ineligible, or refused by the guard);
        the caller updates those, and their own per-metric engines still apply.
        """
        if kwargs:
            # per-member kwarg filtering inside one graph is not supported; positional
            # calls are the collection hot path
            self.stats.fallback("kwargs")
            return set()
        members = self.eligible_members()
        if len(members) < self.min_members:
            self.stats.fallback("too-few-members")
            return set()
        handled = self.run(members, args, {}) or []
        for _, m in handled:
            # the wrapped-update bookkeeping the eager path would have done
            m._computed = None
            m._update_count += 1
        return {name for name, _ in handled}

    def scan_step(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], k: int, async_inflight: Optional[int] = None
    ) -> Optional[Set[str]]:
        """Queue one fused step (``engine/scan.py``); the names of the members it will
        update, or None when nothing was queued (the caller updates every owner)."""
        if self._scan is None:
            from torchmetrics_tpu_torch.engine.scan import FusedScan

            self._scan = FusedScan(self)
        return self._scan.push(args, kwargs, k, async_inflight)

    def _count_refusals(self, refused: List[Tuple[str, str]], demoted: bool) -> None:
        from torchmetrics_tpu_torch.diag import trace

        for name, reason in refused:
            self.stats.fallback_reasons[f"member:{name}:{reason}"] += 1
            trace.record("fused.exclude", self.stats.owner, member=name, reason=reason)
        if demoted:
            self.stats.fallback("too-few-traceable-members")
