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

Left out against the JAX engine: the sentinel, transaction and numerics riders (and
with them ``build_fused_riders``), ``persist``, the ``diag`` / ``profile``
instrumentation and the scan queue.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Set, Tuple

import torch

from torchmetrics_tpu_torch.engine.compiled import GraphEngine, structural_refusal


class FusedUpdate(GraphEngine):
    """One captured graph updating several metrics' states per step."""

    min_members = 2

    def __init__(self, metrics: Sequence[Tuple[str, Any]]) -> None:
        self.metrics: List[Tuple[str, Any]] = list(metrics)
        super().__init__("fused:" + ",".join(type(m).__name__ for _, m in self.metrics))
        self._member_ok: Dict[str, bool] = {}  # structural eligibility, frozen on first sight

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

    def _count_refusals(self, refused: List[Tuple[str, str]], demoted: bool) -> None:
        for name, reason in refused:
            self.stats.fallback_reasons[f"member:{name}:{reason}"] += 1
        if demoted:
            self.stats.fallback("too-few-traceable-members")
