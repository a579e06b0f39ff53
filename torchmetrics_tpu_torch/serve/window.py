"""Streaming aggregation on the card: windowed rings and exponential decay
(counterpart of ``torchmetrics_tpu/serve/window.py``).

- :class:`WindowedMetric`: a fixed ring of ``buckets`` partial states, each covering
  ``bucket_size`` updates. Advance (the ring cursor), evict (reset the re-entered slot
  to its default) and fold (the batch's contribution into the cursor's slot) run in
  one update, so with the engine on they are one graph replay per step; memory is
  ``buckets ×`` the base state, independent of the stream's length.
- :class:`DecayedMetric`: exponential time decay (EMA): an additive state accumulates
  as ``state = decay * state + contribution``.

Both hold their base metric only as a pure body: the batch's contribution comes from
running the base's raw update on its default states through the engine's
``traced_update`` (snapshot/restore of the base's ``__dict__``), never from the base's
live machinery. So they name the attribute in ``_engine_traced_bodies`` and the engine
captures them although they hold an inner metric (``engine/compiled.holds_nested_metrics``).

Nothing in an update reads the host: the clock is a max-reduced ``count_dtype()``
(int64) state, the cursor indexes the ring as a 0-d tensor, and evict-on-entry is a
``torch.where``. The base's defaults are kept as copies on the metric's device (a
host constant would be a host-to-card copy inside the captured graph).

The ring and EMA states are ordinary registered states with the base's reductions,
so the packed sync folds them with no new role; the ``state_dict`` keys are the JAX
package's (``win_<state>``, ``clock``, ``ema_<state>``), the base metric's own states
not among them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.engine.compiled import _Ineligible, _Refused, traced_update
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utilities.data import dim_zero_max, dim_zero_min, dim_zero_sum
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = ["DecayedMetric", "WindowedMetric"]

#: reductions a streaming wrapper folds per slot / per tick: each an associative merge
#: whose identity is the registered default
_FOLDS = {
    dim_zero_sum: ("sum", torch.add),
    dim_zero_max: ("max", torch.maximum),
    dim_zero_min: ("min", torch.minimum),
}

#: the across-slot fold of each kind
_ACROSS = {
    "sum": lambda x: x.sum(dim=0),
    "max": lambda x: x.amax(dim=0),
    "min": lambda x: x.amin(dim=0),
}


def check_streamable(base: Metric, wrapper: str) -> Dict[str, Tuple[str, Any]]:
    """Validate a base metric for the streaming wrappers; returns attr -> fold.

    Eligible: fixed-shape tensor states reduced by sum, max or min, a sum state's
    default the additive identity (all zero), a float max / min state's default the
    fold identity (-inf / +inf). Mean-reduced states are refused with a pointer at the
    sum/count formulation; list, ``None`` and custom states have no slot algebra. The
    default reads ride the ``serve-setup`` boundary (construction, never an update).
    """
    from torchmetrics_tpu_torch.diag.transfer_guard import transfer_allowed

    if not isinstance(base, Metric):
        raise TorchMetricsUserError(
            f"Expected the base metric to be a `torchmetrics_tpu.Metric` but got {base!r}"
        )
    folds: Dict[str, Tuple[str, Any]] = {}
    for attr, red in base._reductions.items():
        default = base._defaults[attr]
        if isinstance(default, list):
            raise TorchMetricsUserError(
                f"{wrapper} cannot stream metric {type(base).__name__!r}: list state"
                f" {attr!r} grows unboundedly — a fixed-memory window cannot hold it."
            )
        fold = _FOLDS.get(red)
        if fold is None:
            hint = (
                " (mean-reduced states have no per-slot identity; use a sum/count"
                " formulation like MeanMetric's instead)"
                if red is not None and getattr(red, "__name__", "") == "dim_zero_mean"
                else ""
            )
            raise TorchMetricsUserError(
                f"{wrapper} cannot stream metric {type(base).__name__!r}: state {attr!r}"
                f" has an unsupported reduction{hint}; only sum/max/min states fold"
                " into ring slots."
            )
        with transfer_allowed("serve-setup"):
            host = default.detach().cpu().numpy()
        if fold[0] == "sum" and host.any():
            raise TorchMetricsUserError(
                f"{wrapper} cannot stream metric {type(base).__name__!r}: sum-reduced"
                f" state {attr!r} has a non-zero default, so the default is not the"
                " fold identity an evicted slot resets to."
            )
        if fold[0] in ("max", "min") and default.is_floating_point():
            # an evicted or never-written slot holds the default, which the across-slot
            # fold treats as transparent only if it is the fold's identity; integer
            # extremum states are exempt (their identity depends on the domain)
            identity = float("-inf") if fold[0] == "max" else float("inf")
            if not bool((host == identity).all()):
                raise TorchMetricsUserError(
                    f"{wrapper} cannot stream metric {type(base).__name__!r}:"
                    f" {fold[0]}-reduced float state {attr!r} has default"
                    f" {host!r}, not the fold identity"
                    f" ({identity}) an evicted slot resets to."
                )
        folds[attr] = fold
    return folds


def capture_np_defaults(base: Metric, keys: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Copies of the base's registered defaults, taken once at construction.

    The JAX package keeps numpy copies (a live device array referenced inside a
    traced body embeds as a graph constant whose materialization reads the device).
    The port keeps them on the metric's device: a captured graph may hold a device
    tensor, while a host constant would be a host-to-card copy inside it. Shared by
    every traced-body wrapper (windows, decay, tenancy)."""
    return {k: base._defaults[k].detach().clone() for k in keys}


def extract_contribution(
    base: Metric,
    defaults: Dict[str, torch.Tensor],
    keys: Tuple[str, ...],
    wrapper: str,
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
) -> Dict[str, Any]:
    """The batch's pure contribution: the base's raw update on its default states,
    under ``traced_update``'s snapshot/restore. An update with side effects is an
    error here, not a fallback; an operation the engine's guard refuses (a host read)
    demotes the engine's step, as it would the base's own."""
    start = {k: defaults[k].clone() for k in keys}
    try:
        return traced_update(base, start, args, kwargs)
    except _Refused:
        raise
    except _Ineligible as exc:
        raise TorchMetricsUserError(f"{wrapper} cannot stream {type(base).__name__!r}: {exc}") from exc


def run_base_compute(base: Metric, states: Dict[str, Any]) -> Any:
    """The base's raw compute body on ``states``, with its ``__dict__`` snapshotted and
    restored. ``_update_count`` is pinned to 1: the states hold real updates, and a raw
    compute body reads the count only for mean weighting, which sum/count bases do
    through their own states."""
    snapshot = dict(base.__dict__)
    try:
        for key, value in states.items():
            object.__setattr__(base, key, value)
        object.__setattr__(base, "_update_count", 1)
        return base._raw_compute()
    finally:
        base.__dict__.clear()
        base.__dict__.update(snapshot)


class _StreamingWrapper(Metric):
    """Shared base: contribution extraction and the base-compute plumbing."""

    #: ``engine/compiled.holds_nested_metrics``' exemption, per attribute: only this
    #: inner metric runs as a traced body; any other nested metric disqualifies
    _engine_traced_bodies = frozenset({"base_metric"})
    #: forward takes the two-update path: the reduce path's reset and merge would
    #: misalign the ring cursor or the decay tick
    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        if base_metric.device != self.device:
            raise TorchMetricsUserError(
                f"{type(self).__name__} on {self.device} cannot stream a base metric on {base_metric.device}"
            )
        self._slot_folds = check_streamable(base_metric, type(self).__name__)
        self.base_metric = base_metric
        self._base_keys = tuple(base_metric._defaults)
        self._np_defaults = capture_np_defaults(base_metric, self._base_keys)

    def _default_of(self, key: str) -> torch.Tensor:
        """The base state's default, a tensor on the metric's device."""
        return self._np_defaults[key]

    def _contribution(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Dict[str, Any]:
        return extract_contribution(self.base_metric, self._np_defaults, self._base_keys, type(self).__name__, args, kwargs)

    def to(self, device: Union[str, torch.device]) -> "_StreamingWrapper":
        """Move the states, the base metric and the kept defaults to ``device``."""
        super().to(device)
        self.base_metric.to(device)
        self._np_defaults = {k: v.to(self.device) for k, v in self._np_defaults.items()}
        return self

    def plot(self, val: Optional[Union[torch.Tensor, Sequence[torch.Tensor]]] = None, ax: Optional[Any] = None) -> Any:
        return self._plot(val, ax)


class WindowedMetric(_StreamingWrapper):
    """Trailing-window metric over a fixed ring of partial states.

    The window covers the last ``buckets * bucket_size`` updates at ``bucket_size``
    granularity: each slot accumulates ``bucket_size`` consecutive updates, and
    re-entering a slot after a full revolution evicts it (resets it to the registered
    default) in the same step. ``compute()`` folds the slots with the base reduction
    (evicted and never-written slots hold the fold identity) and runs the base's
    compute body on the result.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> from torchmetrics_tpu_torch.serve import WindowedMetric
        >>> metric = WindowedMetric(SumMetric(nan_strategy=0.0, device="cpu"), buckets=3, bucket_size=1)
        >>> for v in (1.0, 2.0, 3.0, 4.0):
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())  # sum over the trailing window {2, 3, 4}
        9.0
    """

    def __init__(self, base_metric: Metric, buckets: int = 8, bucket_size: int = 1, **kwargs: Any) -> None:
        super().__init__(base_metric, **kwargs)
        if not (isinstance(buckets, int) and buckets > 0):
            raise ValueError(f"Expected argument `buckets` to be a positive int but got {buckets}")
        if not (isinstance(bucket_size, int) and bucket_size > 0):
            raise ValueError(f"Expected argument `bucket_size` to be a positive int but got {bucket_size}")
        self.buckets = buckets
        self.bucket_size = bucket_size
        for key in self._base_keys:
            default = base_metric._defaults[key]
            ring_default = default.unsqueeze(0).expand((buckets,) + tuple(default.shape)).clone()
            # slot-merge algebra == cross-rank algebra: the slots fold elementwise across
            # ranks with the base state's own reduction
            self.add_state("win_" + key, default=ring_default, dist_reduce_fx=base_metric._reductions[key])
        from torchmetrics_tpu_torch.engine.numerics import count_dtype

        # lockstep tick counter, max-reduced so a sync cannot double-count the shared
        # clock; int64, so an unbounded stream does not wrap it
        self.add_state(
            "clock", default=torch.zeros((), dtype=count_dtype()), dist_reduce_fx="max",
            spec={"role": "ring-clock", "dtype_policy": "count"},
        )

    def update(self, *args: Any, **kwargs: Any) -> None:
        """One stream tick: contribution, advance, evict and fold."""
        contrib = self._contribution(args, kwargs)
        clock = self.clock
        cursor = torch.remainder(torch.div(clock, self.bucket_size, rounding_mode="floor"), self.buckets).reshape(1)
        entering = torch.remainder(clock, self.bucket_size) == 0
        for key in self._base_keys:
            ring = getattr(self, "win_" + key)
            # evict-on-entry: a slot re-entered after a full revolution restarts from
            # the registered default (the fold identity)
            slot = torch.where(entering, self._default_of(key), ring.index_select(0, cursor)[0])
            merged = self._slot_folds[key][1](slot, contrib[key])
            setattr(self, "win_" + key, ring.index_put((cursor,), merged.unsqueeze(0)))
        self.clock = clock + 1

    def compute(self) -> Any:
        """Fold the ring across slots and run the base compute on the result."""
        folded = {key: _ACROSS[self._slot_folds[key][0]](getattr(self, "win_" + key)) for key in self._base_keys}
        return run_base_compute(self.base_metric, folded)


class DecayedMetric(_StreamingWrapper):
    """Exponentially time-decayed metric states (an EMA over the update stream).

    Sum-reduced base states accumulate as ``state = decay * state + contribution``;
    max / min states fold undecayed. A sum/count base like ``MeanMetric`` gives a true
    EMA mean. The effective window is ``1 / (1 - decay)`` updates; ``half_life`` gives
    ``decay = 0.5 ** (1 / half_life)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import SumMetric
        >>> from torchmetrics_tpu_torch.serve import DecayedMetric
        >>> metric = DecayedMetric(SumMetric(nan_strategy=0.0, device="cpu"), decay=0.5)
        >>> for v in (4.0, 2.0, 1.0):
        ...     metric.update(torch.tensor(v))
        >>> float(metric.compute())  # 4*0.25 + 2*0.5 + 1
        3.0
    """

    def __init__(
        self,
        base_metric: Metric,
        decay: Optional[float] = None,
        half_life: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(base_metric, **kwargs)
        if (decay is None) == (half_life is None):
            raise ValueError("Provide exactly one of `decay` or `half_life`")
        if half_life is not None:
            if not (isinstance(half_life, int) and half_life > 0):
                raise ValueError(f"Expected argument `half_life` to be a positive int but got {half_life}")
            decay = 0.5 ** (1.0 / half_life)
        if not (isinstance(decay, float) and 0.0 < decay < 1.0):
            raise ValueError(f"Expected argument `decay` to be a float in (0, 1) but got {decay}")
        self.decay = decay
        # the factor in each state's dtype, as the JAX package casts it (an integer
        # state's factor truncates), kept on the device: no host constant in the step
        self._decay_of = {k: torch.tensor(decay).to(base_metric._defaults[k]) for k in self._base_keys}
        for key in self._base_keys:
            self.add_state("ema_" + key, default=base_metric._defaults[key], dist_reduce_fx=base_metric._reductions[key])

    def to(self, device: Union[str, torch.device]) -> "DecayedMetric":
        super().to(device)
        self._decay_of = {k: v.to(self.device) for k, v in self._decay_of.items()}
        return self

    def update(self, *args: Any, **kwargs: Any) -> None:
        """One stream tick: decay the additive states, fold the contribution in."""
        contrib = self._contribution(args, kwargs)
        for key in self._base_keys:
            kind, fold = self._slot_folds[key]
            state = getattr(self, "ema_" + key)
            if kind == "sum":
                state = state * self._decay_of[key] + contrib[key]
            else:
                state = fold(state, contrib[key])
            setattr(self, "ema_" + key, state)

    def compute(self) -> Any:
        """Run the base compute on the decayed states."""
        return run_base_compute(self.base_metric, {key: getattr(self, "ema_" + key) for key in self._base_keys})
