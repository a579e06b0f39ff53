"""One run of one cell: set-up, the window, the check, and the result's numbers.

``run_cell`` is the whole run short of the look for a card and the printing, so the
tests can drive it on the CPU at small sizes (``sizes``) and with the program broken
underneath (``wrap``); the command line (``run.py``) only ever runs it on the card.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cudabench.harness import checks, peaks, window
from cudabench.harness.ranks import Ranks
from cudabench.harness.spec import Cell
from cudabench.harness.stats import percentile
from cudabench.harness.trace import DeviceOp, HostSpan, Recorder, profiled

TRACE_SECONDS = 2.0  # a traced run profiles at most this long a window
CONTROL_ROUNDING = torch.bfloat16  # the step below float32 that the control takes
CALL_KINDS = ("update", "forward")


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    table: Dict[str, dict]  # each number compared, with its limit
    memory_peak_bytes: int
    notes: Dict[str, Any] = field(default_factory=dict)  # printed to stderr
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


@dataclass
class Traced:
    """What a per-layer metric's reader reads: the spans, the trace, the counters and
    the configuration's byte functions."""

    cell: Cell
    cfg: dict
    rec: Recorder
    trace: Any  # harness.trace.Trace, None when the profiler saw nothing
    result: window.WindowResult
    batches: Dict[int, window.Batch]  # by index: rows, bytes
    engine: Dict[str, int]  # engine_report() counters gained over the window
    hbm_bytes_per_s: float

    def calls(self) -> List[HostSpan]:
        """The spans of the program's update or forward calls, in order."""
        return [s for s in self.rec.spans if s.kind in CALL_KINDS]

    def call_ops(self) -> List[Tuple[DeviceOp, window.Batch]]:
        """Each device operation that an update or forward call launched, with its batch."""
        if self.trace is None:
            return []
        meta = {kind: [s.meta for s in self.rec.of_kind(kind)] for kind in CALL_KINDS}
        return [(op, self.batches[meta[op.span[0]][op.span[1]]["batch"]])
                for op in self.trace.ops if op.span is not None and op.span[0] in CALL_KINDS]


def _engine_counters() -> Dict[str, int]:
    from torchmetrics_tpu_torch.engine import engine_report

    return {k: v for k, v in engine_report().items() if isinstance(v, int)}


def _delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def _answers_gaps(cell: Cell, res: window.WindowResult, final: Optional[dict], want: dict) -> Dict[str, Any]:
    """Every answer the window produced against the reference: the gaps of each answer,
    by kind (``epoch``, ``step``, ``final``)."""
    ref = cell.reference_module
    per_epoch = [checks_for(ref, "epoch", v, want["epoch"]) for _, v in res.epochs]
    per_step = [checks_for(ref, "step", v, want["step"][i]) for _, i, v in res.steps]
    per_final = [checks_for(ref, "final", final, want["final"])] if final is not None else []
    return {"epoch": per_epoch, "step": per_step, "final": per_final}


def checks_for(ref, kind: str, got: dict, want: dict) -> Dict[str, float]:
    return {f"{kind}.{k}": v for k, v in ref.compare(got, want).items()}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float,
             sizes: Optional[dict] = None, wrap: Optional[Callable] = None,
             ranks: Optional[Ranks] = None) -> Optional[Outcome]:
    """Set up, warm up, run the window, check the answers. ``t0``: when the process
    started, by ``time.perf_counter``. ``sizes`` overrides configuration keys (tests
    only); ``wrap`` wraps the built metrics (tests only). With ``ranks``, every rank
    runs its shard and rank 0 alone checks the synced answers and returns the outcome
    (the others return None)."""
    cfg = dict(cell.config, **(sizes or {}))
    traffic = cell.traffic
    cm = cell.config_module
    batch_rows = window.batch_sizes(traffic, seed)
    data = cm.make_data(cfg, seed, device, batch_rows)
    rank, world = (ranks.rank, ranks.world) if ranks else (0, 1)
    plan = cm.plan(cfg, batch_rows, rank, world)
    metrics = cm.build(cfg, device)
    if wrap is not None:
        metrics = wrap(metrics)
    window.warm_up(cm, metrics, data, plan, traffic, device)
    setup_s = time.perf_counter() - t0

    rec = Recorder(traced)
    holder: Dict[str, Any] = {}
    before = _engine_counters()
    with profiled(traced, holder):
        res = window.run(cm, metrics, data, plan, traffic, min(seconds, TRACE_SECONDS) if traced else seconds,
                         rec, seed, device, count_syncs=traced and device.type == "cuda",
                         ranks=ranks)
    engine = _delta(before, _engine_counters())
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tr_ = holder.get("trace")
    device_readings = [(memory_peak, tr_.busy_s if tr_ else None, tr_.window_s if tr_ else None, res.rows)]
    if ranks:
        device_readings = ranks.gather(device_readings[0])
        if ranks.rank != 0:
            return None

    final = None if traffic["epochs"] else cm.read_final(metrics)
    batches = {b.index: b for b in (cm.batch(data, item) for item in plan)}
    if traced:
        tr = Traced(cell, cfg, rec, tr_, res, batches, engine,
                    peaks.hbm_bytes_per_s(torch.cuda.get_device_name(device)) if cuda else float("nan"))
        metric_values = _per_layer(cell, tr)
    else:
        metric_values = _end_to_end(cell, res, sum(r[3] for r in device_readings), setup_s)
    del metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    want = cell.reference_module.expected(cfg, data, plan, res.folds)
    per_kind = _answers_gaps(cell, res, final, want)
    gaps = checks.worst([g for kind in per_kind.values() for g in kind])
    correct, table = checks.decide(gaps, cfg["limits"])
    failed = _failed_calls(per_kind, cfg["limits"], res, len(plan))
    out = Outcome(correct=correct, attempted=res.calls, failed=failed, metrics=metric_values, table=table,
                  memory_peak_bytes=int(max(r[0] for r in device_readings)),
                  notes={"epochs": len(res.epoch_s), "calls": res.calls, "window_s": res.window_s,
                         "setup_s": setup_s, "engine": {k: v for k, v in engine.items() if v},
                         "epoch_ms_quartiles": _quartiles_ms(res.epoch_s)})
    if traced and tr_ is not None:  # busy and window averaged over the ranks' cards
        out.busy_s = sum(r[1] for r in device_readings) / len(device_readings)
        out.window_s = sum(r[2] for r in device_readings) / len(device_readings)
        out.breakdown = tr_.breakdown()
    return out


def _quartiles_ms(values) -> Optional[list]:
    if len(values) < 2:
        return None
    return [q * 1e3 for q in statistics.quantiles(values, n=4)]


def _over(gaps: Dict[str, float], limits: Dict[str, float]) -> bool:
    return not checks.decide(gaps, limits)[0]


def _failed_calls(per_kind: dict, limits: dict, res: window.WindowResult, epoch_calls: int) -> int:
    """Calls whose answer failed: an epoch's calls when its values failed, a step's call
    when its value failed, every call when the final states failed."""
    if any(_over(g, limits) for g in per_kind["final"]):
        return res.calls
    failed_epochs = sum(_over(g, limits) for g in per_kind["epoch"])
    failed_steps = sum(_over(g, limits) for g in per_kind["step"])
    return min(res.calls, failed_epochs * epoch_calls + failed_steps)


def _end_to_end(cell: Cell, res: window.WindowResult, rows: int, setup_s: float) -> Dict[str, dict]:
    """``rows``: folded by every rank over rank 0's window. ``rows_per_s`` and
    ``tokens_per_s`` are the same rate, named for what a configuration's row is."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    rate = rows / res.window_s
    values = {"rows_per_s": rate, "tokens_per_s": rate, "setup_s": setup_s}
    if res.epoch_s:
        values["epoch_p95_ms"] = percentile(res.epoch_s, 95) * 1e3
    return {name: {"value": values[name], "unit": unit} for name, unit in units.items()}


def _per_layer(cell: Cell, tr: Traced) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = cell.layer_reader(m["name"]).read(tr)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def control(cell: Cell, seed: int, device, sizes: Optional[dict] = None, calls: int = 0) -> Dict[str, float]:
    """The control's numbers: the reference computed on ``CONTROL_ROUNDING`` logits, put
    in the program's place, against the reference at the configuration's precision.
    For a stream, the control folds each batch of the cycle ``calls`` times over
    (default: once)."""
    cfg = dict(cell.config, **(sizes or {}))
    cm, ref = cell.config_module, cell.reference_module
    batch_rows = window.batch_sizes(cell.traffic, seed)
    data = cm.make_data(cfg, seed, device, batch_rows)
    plan = cm.plan(cfg, batch_rows)
    folds = {} if cell.traffic["epochs"] else {cm.batch(data, item).index: max(1, calls // len(plan)) for item in plan}
    want = ref.expected(cfg, data, plan, folds)
    low = ref.expected(cfg, data, plan, folds, rounding=CONTROL_ROUNDING)
    gaps = []
    for kind in ("epoch", "final"):
        if kind in want and (kind == "final") != bool(cell.traffic["epochs"]):
            gaps.append(checks_for(ref, kind, ref.as_answer(low[kind]), want[kind]))
    if cell.traffic["read_each_step"]:  # a step's read takes the scalar values alone
        for i in want["step"]:
            got = {k: v for k, v in ref.as_answer(low["step"][i]).items() if np.size(v) == 1}
            gaps.append(checks_for(ref, "step", got, want["step"][i]))
    return checks.worst(gaps)
