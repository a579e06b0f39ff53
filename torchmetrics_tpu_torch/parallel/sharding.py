"""Sharded metric state over a rank mesh (counterpart of ``torchmetrics_tpu/parallel/sharding.py``).

Every state is replicated per rank by default: one whole copy per process, synced at
the epoch boundary by the packed gather. That caps a state at one card's memory. This
module turns a state's ``StateSpec.shard_rule`` (``engine/statespec.py``) into a real
placement, with PyTorch's own SPMD idiom where the JAX package has one controller and
GSPMD:

- **The mesh.** :func:`metric_mesh` resolves the process-wide :class:`StateMesh`: a
  1-D mesh with the named axis :data:`STATE_AXIS` (``"state"``), or a 2-D
  ``("data", "state")`` mesh, laid over the ranks of the default process group, one
  rank per mesh position (rank ``r`` sits at ``(r // S, r % S)``). It hands out a
  ``torch.distributed.device_mesh.DeviceMesh`` per device type and the sub-group of
  each axis. Activation is explicit: :func:`mesh_context` / :func:`set_mesh`, or the
  ``TORCHMETRICS_TPU_SHARD`` environment variable (``"1"``/``"all"`` = every rank, an
  integer N = the first N, ``"DxS"`` = a data-by-state mesh; anything else raises).
  With no mesh every rule resolves to ``None``: replicated state.
- **Born distributed.** ``Metric.add_state`` resolves the registered spec's rule and
  places the default as a ``DTensor``: ``Shard(d)`` over the ``state`` axis (``d`` is
  0 for the named rules) and ``Replicate()`` over ``data``. Each rank holds only its
  block of rows; the registered default is the placed one, so ``reset`` keeps the
  placement. A rule that cannot partition the value (a scalar, no state axis, a dim
  the axis does not divide) degrades to replication, counted in ``shard_degrades``
  and recorded as ``shard.fallback``.
- **Inputs are replicated over ``state``**, as in tensor parallelism: every rank of a
  state group sees the same batch (:func:`shard_batch` hands each data row its slice
  of a global batch).
- **Updates are shard-local.** Update bodies and the engines work on the local shard
  (:func:`local`), never through DTensor's operator propagation: a class counts what
  its rows own (:func:`local_block`, :func:`local_rows`), the engines capture the step
  over the local shards as static buffers (``engine/compiled.py``'s ``step_state`` /
  ``bind_buffers``) and key their caches on :func:`placement_token`. The update loop
  issues no collective.
- **Sync.** On a 1-D mesh a sharded state is global by construction, so the packed
  gather and the eager sync skip it (``gather_skipped``; ``psum_syncs`` for additive
  folds). On a ``(data, state)`` mesh each rank holds its data row's contribution to
  its block: the fold over ``data`` is deferred to the sync, one all-reduce per
  sharded state over the rank's ``data`` sub-group (where the JAX executable sums it
  in-graph at every step), and the replicated states ride the packed exchange over
  the same sub-group (:func:`sync_scope`). ``compute`` assembles each sharded state
  over its ``state`` sub-group (:func:`full_view`: one list ``all_gather`` per state,
  the collective ``parallel/sync.raw_all_gather`` runs), and the body runs on the
  assembled values.
- **Lifecycle.** Riders stay rank-local: the sentinel and quarantine scalars are
  replicated, and a compensation residual is the local block of its value. Clones
  and pickles keep the ``DTensor``; ``state_dict`` writes each sharded state whole
  (assembled, like the JAX host round-trip), and ``load_state_dict``, unpickling and
  ``restore_resharded`` re-place from the registered rules (:func:`reshard_states`).

Where the JAX package names devices, the port names ranks: "only N devices exist"
reads "only N ranks exist". ``shard_batch`` returns the rank's row slice where the JAX
function returns a data-sharded global array.
"""

from __future__ import annotations

import os
import re
from contextlib import contextmanager
from typing import Any, Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.diag import trace as _diag
from torchmetrics_tpu_torch.engine.stats import EngineStats
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

__all__ = [
    "DATA_AXIS",
    "MULTIHOST_ENV_VAR",
    "SHARD_ENV_VAR",
    "STATE_AXIS",
    "apply_partition_rule",
    "axis_size",
    "build_mesh",
    "data_axis_size",
    "ensure_multihost",
    "is_sharded",
    "match_partition_rule",
    "mesh_context",
    "metric_mesh",
    "multihost_spec",
    "partition_dim0",
    "partition_rules_context",
    "place_state",
    "placement_token",
    "reshard_states",
    "set_mesh",
    "set_partition_rules",
    "shard_batch",
    "sharding_enabled",
    "state_out_shardings",
]

SHARD_ENV_VAR = "TORCHMETRICS_TPU_SHARD"
MULTIHOST_ENV_VAR = "TORCHMETRICS_TPU_MULTIHOST"

#: the named mesh axis shard rules partition over
STATE_AXIS = "state"
#: the named batch axis of the 2-D ``(data, state)`` mesh: each data row sees its own
#: batches, and the sync folds sharded states over it
DATA_AXIS = "data"

#: the attribute a metric keeps its placed states' layouts under
LAYOUT_ATTR = "_shard_layout"
#: the attribute of a placed ``DTensor`` that holds the exact local tensor it wraps
#: (``DTensor.from_local`` wraps a view; the engines' buffers are matched by identity)
_LOCAL_ATTR = "_tm_local"

_UNSET = object()
_mesh_override: Any = _UNSET

# mesh placement is a process-wide fact: one EngineStats joins the weak registry so
# engine_report() and the telemetry aggregate it (the module global keeps it alive)
_STATS = EngineStats("sharding")

# set the first time a state is placed distributed: until then placement_token is
# the bare device string, so processes that never shard pay one bool check per step
_ever_placed = False

# meshes by (axes, ranks): env resolution returns the same object, so the device
# meshes and sub-groups it made (collectives to create) are made once
_MESHES: Dict[Tuple, "StateMesh"] = {}


# ------------------------------------------------------------------ the mesh


class StateMesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps each axis name to its size, in order; ``devices`` is the array of
    ranks (the JAX ``Mesh.devices``). ``device_mesh(device_type)`` is the
    ``DeviceMesh`` of DTensor placements on that device type, and ``group(axis,
    device_type)`` this rank's sub-group along ``axis``; both are made at first use,
    on every rank in the same order (their sub-groups are collectives to create).
    """

    def __init__(self, axis_names: Tuple[str, ...], ranks: np.ndarray) -> None:
        self.axis_names = tuple(axis_names)
        self.devices = ranks
        self.shape = dict(zip(self.axis_names, (int(d) for d in ranks.shape)))
        self._device_meshes: Dict[str, Any] = {}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_mesh(self, device_type: str) -> Any:
        dm = self._device_meshes.get(device_type)
        if dm is None:
            from torch.distributed.device_mesh import DeviceMesh

            dm = self._device_meshes[device_type] = DeviceMesh(
                device_type, torch.as_tensor(self.devices), mesh_dim_names=self.axis_names
            )
        return dm

    def coordinate(self, rank: Optional[int] = None) -> Optional[Dict[str, int]]:
        """This rank's (or ``rank``'s) index along each axis, or None outside the mesh."""
        if rank is None:
            rank = _rank()
        hit = np.argwhere(self.devices == rank)
        if not len(hit):
            return None
        return dict(zip(self.axis_names, (int(i) for i in hit[0])))

    def group(self, axis: str, device_type: str = "cpu") -> Any:
        """This rank's process group along ``axis``."""
        return self.device_mesh(device_type).get_group(axis)

    def __repr__(self) -> str:
        return f"StateMesh({', '.join(f'{a}={n}' for a, n in self.shape.items())})"


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist

    return int(dist.get_rank()) if _distributed() else 0


def _world() -> int:
    import torch.distributed as dist

    return int(dist.get_world_size()) if _distributed() else 1


def build_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None, data: Optional[int] = None) -> StateMesh:
    """A :class:`StateMesh` for metric state, 1-D or 2-D.

    With ``data`` unset (or 1) the mesh has the one axis ``"state"``; with ``data >=
    2`` the ranks reshape to ``(data, state)``. ``devices`` (a list of ranks) wins when
    given; otherwise the first ``data * n_devices`` ranks of the default process group
    (all of them when ``n_devices`` is None). Fewer than 2 ranks is an error: a
    1-rank mesh would demote every rule to replication while sharding reads as on.
    """
    dsize = 1 if data is None else data
    if not isinstance(dsize, int) or isinstance(dsize, bool) or dsize < 1:
        raise TorchMetricsUserError(f"the 'data' mesh axis needs an integer size >= 1 (got {data!r})")
    ensure_multihost()
    if devices is None:
        world = list(range(_world()))
        if n_devices is not None:
            min_state = 2 if dsize == 1 else 1
            if not isinstance(n_devices, int) or isinstance(n_devices, bool) or n_devices < min_state:
                raise TorchMetricsUserError(
                    f"a state mesh needs an integer rank count >= 2 (got {n_devices!r})"
                    if dsize == 1
                    else f"the 'state' axis of a (data, state) mesh needs an integer size >= 1 (got {n_devices!r})"
                )
            if dsize * n_devices > len(world):
                raise TorchMetricsUserError(
                    (
                        f"requested a {dsize}x{n_devices} (data, state) mesh but only"
                        if dsize > 1
                        else f"requested a {n_devices}-rank state mesh but only"
                    )
                    + f" {len(world)} ranks exist (start one process per mesh position:"
                    " torch.distributed.init_process_group with a larger world_size)"
                )
            world = world[: dsize * n_devices]
        elif dsize > 1 and len(world) % dsize != 0:
            raise TorchMetricsUserError(
                f"a data axis of {dsize} does not divide the {len(world)}-rank world evenly;"
                " pass an explicit state size (e.g. mesh_context(data=2, state=2))"
            )
        devices = world
    devices = [int(d) for d in devices]
    if len(devices) < 2:
        raise TorchMetricsUserError(
            f"a state mesh needs >= 2 ranks (got {len(devices)}); with one rank every shard"
            " rule is a no-op — leave sharding off instead"
        )
    if dsize > 1:
        if len(devices) % dsize != 0:
            raise TorchMetricsUserError(
                f"a data axis of {dsize} does not divide the {len(devices)}-rank list evenly"
                " — a (data, state) mesh must be rectangular"
            )
        axes: Tuple[str, ...] = (DATA_AXIS, STATE_AXIS)
        ranks = np.asarray(devices).reshape(dsize, -1)
    else:
        axes, ranks = (STATE_AXIS,), np.asarray(devices)
    key = (axes, tuple(ranks.shape), tuple(ranks.flat))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = StateMesh(axes, ranks)
    return mesh


_SPEC_HELP = "(expected unset/'0'/'off', '1'/'on'/'all', an integer N >= 2, or a 2-D 'DxS' data-by-state spec such as '2x4')"


def _env_mesh() -> Optional[StateMesh]:
    """The mesh ``TORCHMETRICS_TPU_SHARD`` names, or None; an invalid value raises."""
    raw = os.environ.get(SHARD_ENV_VAR, "").strip().lower()
    if raw in ("", "0", "off"):
        return None
    if raw in ("1", "on", "all"):
        return build_mesh()
    if "x" in raw:
        head, _, tail = raw.partition("x")
        try:
            dn, sn = int(head), int(tail)
        except ValueError:
            raise TorchMetricsUserError(f"{SHARD_ENV_VAR}={raw!r} is not a valid mesh spec {_SPEC_HELP}") from None
        if dn < 1 or sn < 1 or dn * sn < 2:
            raise TorchMetricsUserError(
                f"{SHARD_ENV_VAR}={raw!r} names a {dn}x{sn} mesh — both axes must be >= 1"
                " and the mesh must span >= 2 ranks"
            )
        return build_mesh(sn, data=dn) if dn > 1 else build_mesh(sn)
    try:
        n = int(raw)
    except ValueError:
        raise TorchMetricsUserError(f"{SHARD_ENV_VAR}={raw!r} is not a valid state-mesh size {_SPEC_HELP}") from None
    return build_mesh(n)


def metric_mesh() -> Optional[StateMesh]:
    """The active state mesh, or None (sharding off: replicated state)."""
    if _mesh_override is not _UNSET:
        return _mesh_override
    return _env_mesh()


def set_mesh(mesh: Any = None, *, data: Optional[int] = None, state: Optional[int] = None) -> None:
    """Force the state mesh process-wide: a ready :class:`StateMesh`, a rank count,
    ``True`` (every rank) or ``False`` (sharding off whatever the env says); None
    restores env resolution. ``data=`` / ``state=`` build a 2-D mesh instead and
    exclude a positional ``mesh``."""
    global _mesh_override
    if data is not None or state is not None:
        if mesh is not None and mesh is not True:
            raise TorchMetricsUserError("pass either a mesh/rank count or data=/state= axis sizes, not both")
        _mesh_override = build_mesh(state, data=data)
        return
    if mesh is None:
        _mesh_override = _UNSET
    elif mesh is False:
        _mesh_override = None
    elif mesh is True:
        _mesh_override = build_mesh()
    elif isinstance(mesh, int):
        _mesh_override = build_mesh(mesh)
    else:
        _mesh_override = mesh


@contextmanager
def mesh_context(mesh: Any = True, *, data: Optional[int] = None, state: Optional[int] = None) -> Generator[Any, None, None]:
    """Scoped state-mesh activation; yields the active mesh (or None). States placed
    inside the scope stay placed after it; only new placements see the old policy."""
    global _mesh_override
    prev = _mesh_override
    if data is not None or state is not None:
        set_mesh(None if mesh is True else mesh, data=data, state=state)
    else:
        set_mesh(mesh)
    try:
        yield metric_mesh()
    finally:
        _mesh_override = prev


def sharding_enabled() -> bool:
    """Whether an active mesh makes shard rules resolve to real placements."""
    return metric_mesh() is not None


# ------------------------------------------------------------------ multi-host

# one-way latch: the default process group is initialised once per process
_multihost_initialized = False


def multihost_spec() -> Optional[Dict[str, Any]]:
    """Parse ``TORCHMETRICS_TPU_MULTIHOST``: ``""``/``"0"``/``"off"`` = None;
    ``"1"``/``"on"``/``"auto"`` = ``{}`` (the launcher's ``MASTER_ADDR`` / ``RANK`` /
    ``WORLD_SIZE`` environment); ``"host:port:num_processes:process_id"`` pins all
    three. Anything else raises."""
    raw = os.environ.get(MULTIHOST_ENV_VAR, "").strip()
    low = raw.lower()
    if low in ("", "0", "off"):
        return None
    if low in ("1", "on", "auto"):
        return {}
    parts = raw.split(":")
    if len(parts) == 4:
        try:
            return {
                "coordinator_address": f"{parts[0]}:{int(parts[1])}",
                "num_processes": int(parts[2]),
                "process_id": int(parts[3]),
            }
        except ValueError:
            pass
    raise TorchMetricsUserError(
        f"{MULTIHOST_ENV_VAR}={raw!r} is not a valid multi-host spec (expected"
        " unset/'0'/'off', '1'/'on'/'auto', or 'host:port:num_processes:process_id')"
    )


def ensure_multihost() -> bool:
    """Form the world the knob names, once (False = knob off). Initialises the default
    process group (``nccl`` with CUDA, ``gloo`` otherwise) unless one is up already;
    a failure propagates."""
    global _multihost_initialized
    spec = multihost_spec()
    if spec is None:
        return False
    if _multihost_initialized:
        return True
    import torch.distributed as dist

    if not _distributed():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if spec:
            dist.init_process_group(
                backend, init_method=f"tcp://{spec['coordinator_address']}",
                world_size=spec["num_processes"], rank=spec["process_id"],
            )
        else:
            dist.init_process_group(backend)
    _multihost_initialized = True
    _diag.record("multihost.init", "sharding", processes=_world(), process=_rank(), explicit=bool(spec))
    return True


def axis_size() -> int:
    """Ranks along the ``"state"`` axis of the active mesh (1 when off)."""
    mesh = metric_mesh()
    return 1 if mesh is None else int(mesh.shape.get(STATE_AXIS, 1))


def data_axis_size() -> int:
    """Ranks along the ``"data"`` axis of the active mesh (1 when off or 1-D)."""
    mesh = metric_mesh()
    return 1 if mesh is None else int(mesh.shape.get(DATA_AXIS, 1))


def shard_batch(x: Any) -> Any:
    """This rank's data-row slice of a global batch's leading dim: every rank of one
    state group gets the same rows. ``x`` itself when no data axis is live or the
    leading dim is not divisible by it (inputs are transient, so this is exact)."""
    mesh = metric_mesh()
    n = data_axis_size()
    shape = tuple(getattr(x, "shape", ()))
    if mesh is None or n < 2 or not shape or shape[0] % n != 0:
        return x
    coord = mesh.coordinate()
    if coord is None:
        return x
    rows = shape[0] // n
    return x[coord[DATA_AXIS] * rows : (coord[DATA_AXIS] + 1) * rows]


# ------------------------------------------------------------------ predicates


def _dtensor_type() -> Any:
    from torch.distributed.tensor import DTensor

    return DTensor


def _state_dim(value: Any) -> Optional[int]:
    """The tensor dim a ``DTensor`` shards over its ``state`` mesh dim, or None."""
    mesh = value.device_mesh
    names = mesh.mesh_dim_names or ()
    if STATE_AXIS not in names:
        return None
    idx = names.index(STATE_AXIS)
    if mesh.mesh.shape[idx] < 2:
        return None
    placement = value.placements[idx]
    return placement.dim if placement.is_shard() else None


def is_sharded(value: Any) -> bool:
    """True when ``value`` is a ``DTensor`` partitioned over a ``state`` mesh dim of 2
    or more ranks: placement truth, so a state whose rule degraded reads False."""
    if not isinstance(value, torch.Tensor) or type(value).__name__ != "DTensor":
        return False
    return _state_dim(value) is not None


def spans_processes(value: Any) -> bool:
    """Whether ``value``'s placement covers more than one process: in the port a mesh
    position is a rank, so every sharded state does."""
    return is_sharded(value)


def local(value: Any) -> Any:
    """The local tensor of a placed state (the exact tensor it wraps), else ``value``."""
    if isinstance(value, torch.Tensor) and type(value).__name__ == "DTensor":
        held = getattr(value, _LOCAL_ATTR, None)
        return held if held is not None else value._local_tensor
    return value


def holds_sharded(metric: Any) -> bool:
    """Whether any registered state of ``metric`` is live-sharded."""
    if not _ever_placed:
        return False
    return any(is_sharded(metric.__dict__.get(k)) for k in metric._defaults)


def _record_degrade(spec: Any, reason: str, shape: Tuple[int, ...], axis: int) -> None:
    """One degrade to replication: counted in ``shard_degrades`` and recorded."""
    _STATS.shard_degrades += 1
    _diag.record(
        "shard.fallback", "sharding",
        state=getattr(spec, "name", ""), rule=getattr(spec, "shard_rule", ""), reason=reason, shape=shape, axis=axis,
    )


class Partition:
    """A resolved placement: the mesh and the axis name (or None) of each tensor dim
    (the JAX ``NamedSharding``'s ``mesh`` and ``spec``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: StateMesh, spec: Tuple[Optional[str], ...]) -> None:
        self.mesh = mesh
        self.spec = tuple(spec)

    def __repr__(self) -> str:
        return f"Partition({self.mesh!r}, {self.spec})"


def partition_dim0(spec: Any, value: Any = None) -> Optional[Partition]:
    """Resolve a dim-0 rule to a :class:`Partition`, or None (replicate): no mesh, no
    value, a scalar, no live ``state`` axis, or a leading dim the axis does not divide
    (recorded and counted, since a mesh failing to shard is an operator-visible fact)."""
    mesh = metric_mesh()
    if mesh is None or value is None:
        return None
    shape = tuple(getattr(value, "shape", ()))
    n = int(mesh.shape.get(STATE_AXIS, 1))
    if not shape or n < 2 or shape[0] % n != 0:
        reason = "scalar" if not shape else ("no-state-axis" if n < 2 else "indivisible")
        _record_degrade(spec, reason, shape, n)
        return None
    return Partition(mesh, (STATE_AXIS,))


# ------------------------------------------------------------------ rule table

# per-state-name partition rules (regex -> per-dim axes), consulted before the named
# rule: the operator's channel to shard a state without editing its class
_partition_rules: Tuple[Tuple[Any, Tuple[Optional[str], ...]], ...] = ()


def _compile_rules(rules: Optional[Sequence[Tuple[str, Any]]]) -> Tuple:
    compiled = []
    for entry in rules or ():
        try:
            pattern, spec = entry
        except (TypeError, ValueError):
            raise TorchMetricsUserError(f"partition rules are (regex, spec) pairs (got {entry!r})") from None
        try:
            rx = re.compile(pattern)
        except re.error as exc:
            raise TorchMetricsUserError(f"invalid partition-rule regex {pattern!r}: {exc}") from None
        if spec is None:
            axes: Tuple[Optional[str], ...] = ()
        elif isinstance(spec, str):
            axes = (spec,)
        elif isinstance(spec, (tuple, list)):
            axes = tuple(spec)
        else:
            raise TorchMetricsUserError(
                f"partition rule {pattern!r} names an unsupported spec {spec!r}"
                " (expected None, an axis name, or a tuple of axis names/None)"
            )
        for ax in axes:
            if ax is not None and ax not in (DATA_AXIS, STATE_AXIS):
                raise TorchMetricsUserError(
                    f"partition rule {pattern!r} names unknown mesh axis {ax!r}"
                    f" (known axes: {DATA_AXIS!r}, {STATE_AXIS!r})"
                )
        compiled.append((rx, axes))
    return tuple(compiled)


def set_partition_rules(rules: Optional[Sequence[Tuple[str, Any]]]) -> None:
    """Install the process-wide partition-rule table: ordered ``(regex, spec)`` pairs,
    the first regex to ``re.search`` a state's ``"<MetricClass>/<state>"`` (or bare
    name) wins; ``spec`` is an axis name (dim 0), a tuple of axis names or None per
    dim, or None to force replication. Validated at install; None or () clears it."""
    global _partition_rules
    _partition_rules = _compile_rules(rules)


@contextmanager
def partition_rules_context(rules: Optional[Sequence[Tuple[str, Any]]]) -> Generator[None, None, None]:
    """Scoped partition-rule table (see :func:`set_partition_rules`)."""
    global _partition_rules
    prev = _partition_rules
    _partition_rules = _compile_rules(rules)
    try:
        yield
    finally:
        _partition_rules = prev


def partition_rules_active() -> bool:
    """Whether any per-state-name partition rule is installed."""
    return bool(_partition_rules)


def match_partition_rule(name: str, owner: str = "") -> Optional[Tuple[str, Tuple[Optional[str], ...]]]:
    """First table entry matching ``owner/name``: ``(pattern, axes)`` or None."""
    if not _partition_rules:
        return None
    qualified = f"{owner}/{name}" if owner else name
    for rx, axes in _partition_rules:
        if rx.search(qualified):
            return (rx.pattern, axes)
    return None


def apply_partition_rule(spec: Any, value: Any, axes: Sequence[Optional[str]]) -> Optional[Partition]:
    """Resolve a table entry's per-dim axes to a :class:`Partition` (or None), checking
    each dim: an absent axis (< 2 ranks), a dim past the value's rank or an
    indivisible dim degrades that dim, recorded once per resolution."""
    mesh = metric_mesh()
    if mesh is None or value is None:
        return None
    if not any(a is not None for a in axes):
        return None  # an explicit replicate entry: intent, not degradation
    shape = tuple(getattr(value, "shape", ()))
    if not shape:
        _record_degrade(spec, "scalar", shape, 0)
        return None
    resolved: List[Optional[str]] = []
    reason = ""
    for i, ax in enumerate(axes):
        if ax is None:
            resolved.append(None)
            continue
        n = int(mesh.shape.get(ax, 1))
        if n < 2:
            reason = reason or "axis-missing"
            resolved.append(None)
        elif i >= len(shape):
            reason = reason or "rank-mismatch"
            resolved.append(None)
        elif shape[i] % n != 0:
            reason = reason or "indivisible"
            resolved.append(None)
        else:
            resolved.append(ax)
    if reason:
        _record_degrade(spec, reason, shape, int(mesh.shape.get(STATE_AXIS, 1)))
    while resolved and resolved[-1] is None:
        resolved.pop()
    if not any(resolved):
        return None
    return Partition(mesh, tuple(resolved))


# ------------------------------------------------------------------ placement


class Layout:
    """How a placed state splits: the tensor dim sharded over ``state``, its block
    ``[lo, hi)`` on this rank, the global shape, and the DTensor mesh and placements."""

    __slots__ = ("mesh", "device_mesh", "placements", "dim", "lo", "hi", "shape", "local_shape", "stride", "token")

    def __init__(self, mesh: StateMesh, device_mesh: Any, placements: tuple, dim: int, lo: int, hi: int, shape: tuple) -> None:
        self.mesh, self.device_mesh, self.placements = mesh, device_mesh, placements
        self.dim, self.lo, self.hi, self.shape = dim, lo, hi, tuple(shape)
        stride, acc = [], 1
        for d in reversed(self.shape):
            stride.append(acc)
            acc *= d
        self.stride = tuple(reversed(stride))
        self.local_shape = self.shape[:dim] + (hi - lo,) + self.shape[dim + 1 :]
        # the cache-key part, made once: the step's key build reads no tensor
        ranks = ",".join(str(int(r)) for r in mesh.devices.flat)
        self.token = f"{placements}:{STATE_AXIS}@{ranks}"

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full-shape tensor (a view)."""
        return x.narrow(self.dim, self.lo, self.hi - self.lo)

    def owned_block(self, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        """This rank's block of ``x`` as a tensor of its own on ``device``: the whole
        value is not kept alive, and only the block crosses to the device."""
        return self.block(x).to(device, copy=True, memory_format=torch.contiguous_format)

    def wrap(self, local_tensor: torch.Tensor) -> Any:
        """A ``DTensor`` over ``local_tensor`` (no copy, no collective)."""
        out = _dtensor_type().from_local(
            local_tensor, self.device_mesh, self.placements, run_check=False,
            shape=torch.Size(self.shape), stride=self.stride,
        )
        object.__setattr__(out, _LOCAL_ATTR, local_tensor)
        return out


def _layout_for(value: torch.Tensor, partition: Partition, spec: Any, device: torch.device) -> Optional[Layout]:
    """The :class:`Layout` of ``value`` under ``partition``, or None when the port
    cannot place it: a partition over ``data`` (each data row holds its own
    contribution, so only ``state`` splits a state here), recorded as a degrade."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = partition.mesh
    coord = mesh.coordinate()
    if coord is None:
        return None
    dims = [i for i, ax in enumerate(partition.spec) if ax == STATE_AXIS]
    if any(ax == DATA_AXIS for ax in partition.spec):
        _record_degrade(spec, "data-axis", tuple(value.shape), int(mesh.shape.get(STATE_AXIS, 1)))
    if not dims:
        return None
    dim = dims[0]
    n = mesh.shape[STATE_AXIS]
    rows = value.shape[dim] // n
    lo = coord[STATE_AXIS] * rows
    placements = tuple(Shard(dim) if ax == STATE_AXIS else Replicate() for ax in mesh.axis_names)
    return Layout(mesh, mesh.device_mesh(device.type), placements, dim, lo, lo + rows, tuple(value.shape))


def _layouts(metric: Any) -> Dict[str, Layout]:
    table = metric.__dict__.get(LAYOUT_ATTR)
    if table is None:
        table = {}
        object.__setattr__(metric, LAYOUT_ATTR, table)
    return table


def place_state(metric: Any, name: str, value: Any, spec: Any) -> Any:
    """Place one full-shape state by its rule (or return it unchanged): this rank's
    block, copied to the metric's device, wrapped as a ``DTensor``. The born-distributed
    entry point of ``add_state``; counted in ``shard_states``, recorded as
    ``shard.place``."""
    from torchmetrics_tpu_torch.engine import statespec as _statespec

    partition = _statespec.resolve_shard_rule(spec, value, owner=type(metric).__name__)
    if partition is None:
        return value
    layout = _layout_for(value, partition, spec, metric.device)
    if layout is None:
        return value
    global _ever_placed
    _ever_placed = True
    _layouts(metric)[name] = layout
    placed = layout.wrap(layout.owned_block(value, metric.device))
    _STATS.shard_states += 1
    _diag.record(
        "shard.place", type(metric).__name__,
        state=name, rule=spec.shard_rule, axis=int(partition.mesh.shape.get(STATE_AXIS, 1)), shape=tuple(value.shape),
    )
    return placed


def reshard_states(metric: Any) -> int:
    """Re-apply the registered rules to a metric's whole-shape states (and registered
    defaults) after a host round-trip: ``load_state_dict``, ``restore_resharded``, an
    unpickle. The active mesh resolves the rules; without one, a state placed before
    keeps its layout. A residual of a re-placed value is cut to its block."""
    specs = metric.__dict__.get("_state_specs") or {}
    mesh = metric_mesh()
    known = metric.__dict__.get(LAYOUT_ATTR) or {}
    if not specs or (mesh is None and not known):
        return 0
    from torchmetrics_tpu_torch.engine import numerics
    from torchmetrics_tpu_torch.engine import statespec as _statespec

    owner = type(metric).__name__
    placed = 0
    residuals = metric.__dict__.get(numerics.ATTR) or {}
    for name, spec in specs.items():
        ruled = spec.shard_rule != "replicate" or match_partition_rule(name, owner) is not None
        if not ruled and name not in known:
            continue
        for holder in ("state", "default"):
            value = metric.__dict__.get(name) if holder == "state" else metric._defaults.get(name)
            if not isinstance(value, torch.Tensor) or is_sharded(value):
                continue
            value = local(value)
            layout = None
            if mesh is not None and ruled:
                partition = _statespec.resolve_shard_rule(spec, value, owner=owner)
                layout = None if partition is None else _layout_for(value, partition, spec, metric.device)
            if layout is None and name in known and tuple(value.shape) == known[name].shape:
                layout = known[name]
            if layout is None:
                continue
            _layouts(metric)[name] = layout
            new = layout.wrap(layout.owned_block(value, metric.device))
            if holder == "state":
                metric.__dict__[name] = new
                res = residuals.get(name)
                if isinstance(res, torch.Tensor) and tuple(res.shape) == layout.shape:
                    residuals[name] = layout.owned_block(res, res.device)
            else:
                metric._defaults[name] = new
            placed += 1
    if placed:
        global _ever_placed
        _ever_placed = True
        _STATS.shard_states += placed
        _diag.record("shard.reshard", owner, placed=placed, axis=axis_size())
    return placed


def local_block(metric: Any, name: str, contribution: torch.Tensor) -> torch.Tensor:
    """The part of a full-shape batch ``contribution`` that state ``name``'s shard owns
    on this rank (a view); ``contribution`` itself when the state is not placed. An
    update body adds it to the local shard: the GSPMD split around a custom call."""
    layout = (metric.__dict__.get(LAYOUT_ATTR) or {}).get(name)
    return contribution if layout is None else layout.block(contribution)


def local_rows(metric: Any, name: str) -> Optional[Tuple[int, int]]:
    """``(lo, hi)``: the dim-0 rows state ``name``'s shard owns, or None (not placed, or
    placed over another dim)."""
    layout = (metric.__dict__.get(LAYOUT_ATTR) or {}).get(name)
    if layout is None or layout.dim != 0:
        return None
    return layout.lo, layout.hi


def wrap_like(metric: Any, name: str, local_tensor: Any) -> Any:
    """``local_tensor`` as the metric's placed state ``name`` (the engines' write-back),
    or unchanged when ``name`` is not placed or the tensor is already global-shaped."""
    layout = (metric.__dict__.get(LAYOUT_ATTR) or {}).get(name)
    if (
        layout is None
        or not isinstance(local_tensor, torch.Tensor)
        or type(local_tensor).__name__ == "DTensor"
        or tuple(local_tensor.shape) != layout.local_shape
    ):
        return local_tensor
    return layout.wrap(local_tensor)


@contextmanager
def local_states(metric: Any) -> Generator[None, None, None]:
    """Swap every placed state of ``metric`` for its local shard for the duration (the
    eager update body), and wrap what the body left back as ``DTensor``s."""
    layouts = metric.__dict__.get(LAYOUT_ATTR)
    if not layouts:
        yield
        return
    d = metric.__dict__
    for name in layouts:
        if name in d:
            d[name] = local(d[name])
    try:
        yield
    finally:
        for name in layouts:
            if name in d:
                d[name] = wrap_like(metric, name, d[name])


def assemble(value: Any) -> Any:
    """The whole value of a sharded state, gathered over its ``state`` sub-group with
    one list ``all_gather`` (``parallel/sync.raw_all_gather``, which gloo runs on CUDA
    tensors too); a replicated ``DTensor``'s local value; anything else unchanged."""
    if not isinstance(value, torch.Tensor) or type(value).__name__ != "DTensor":
        return value
    dim = _state_dim(value)
    loc = local(value)
    if dim is None:
        return loc
    from torchmetrics_tpu_torch.parallel import sync as _sync

    group = value.device_mesh.get_group(STATE_AXIS)
    parts = _sync.raw_all_gather(loc.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


@contextmanager
def full_view(metric: Any) -> Generator[None, None, None]:
    """Swap every sharded state of ``metric`` for its assembled whole value for the
    duration (``compute``), then put the placed states back. One collective per
    sharded state, on every rank of its state group."""
    if not _ever_placed:
        yield
        return
    d = metric.__dict__
    saved = {k: d[k] for k in metric._defaults if is_sharded(d.get(k))}
    if not saved:
        yield
        return
    for k, v in saved.items():
        d[k] = assemble(v)
    try:
        yield
    finally:
        d.update(saved)


# ------------------------------------------------------------------ sync scope


def metric_state_mesh(metric: Any) -> Optional[StateMesh]:
    """The mesh a metric's states were placed on, else the active mesh."""
    for layout in (metric.__dict__.get(LAYOUT_ATTR) or {}).values():
        return layout.mesh
    return metric_mesh()


def sync_scope(metrics: Sequence[Any]) -> Tuple[int, Any]:
    """``(world size, process group)`` the replicated states' exchange runs over. No
    mesh: the default group. A mesh: the rank's ``data`` sub-group (its state group
    holds copies of one data row, so folding over the world would count each row S
    times); a 1-D mesh is one data row, so ``(1, None)``."""
    from torchmetrics_tpu_torch.parallel import sync as _sync

    mesh = None
    for m in metrics:
        mesh = metric_state_mesh(m)
        if mesh is not None:
            break
    if mesh is None or not _distributed() or mesh.coordinate() is None:
        return _sync.world_size(), None
    n = int(mesh.shape.get(DATA_AXIS, 1))
    if n < 2:
        return 1, None
    device_type = next((m.device.type for m in metrics), "cpu")
    return n, mesh.group(DATA_AXIS, device_type)


def fold_over_data(value: Any, fold: str, group: Any, size: int) -> Any:
    """A sharded state folded over the ``data`` sub-group (the deferred fold of a 2-D
    mesh): one all-reduce of a copy of the local shard, re-wrapped. ``mean`` sums and
    divides by the data size."""
    import torch.distributed as dist

    op = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[fold]
    loc = local(value).clone()
    dist.all_reduce(loc, op=op, group=group)
    if fold == "mean":
        loc = loc / size if loc.is_floating_point() else loc // size
    out = _dtensor_type().from_local(
        loc, value.device_mesh, value.placements, run_check=False, shape=value.shape, stride=value.stride()
    )
    object.__setattr__(out, _LOCAL_ATTR, loc)
    return out


# ------------------------------------------------------------------ engine glue


def state_out_shardings(example_state: Any) -> Optional[Dict[str, Any]]:
    """The engines' local-shard layout of a state dict: None when no value is sharded
    (the common case), else each sharded value's placements (None for the rest). The
    engines capture over the local shards and write back through :func:`wrap_like`."""
    if not isinstance(example_state, dict) or not any(is_sharded(v) for v in example_state.values()):
        return None
    return {k: (v.placements if is_sharded(v) else None) for k, v in example_state.items()}


def placement_token(state: Any) -> str:
    """Cache-key component naming a state's placement: the first tensor's device
    string until any state is placed (the pre-sharding key at O(1) cost), then that
    string plus each sharded value's placements and ranks, so a re-placed state builds
    a fresh graph instead of replaying one captured for another layout."""
    leaves = list(state.values()) if isinstance(state, dict) else list(state)
    if not _ever_placed:
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                return str(leaf.device)
        return ""
    first, parts = "", []
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            continue
        if not first:
            first = str(local(leaf).device)
        if is_sharded(leaf):
            ranks = ",".join(str(int(r)) for r in leaf.device_mesh.mesh.flatten().tolist())
            parts.append(f"{tuple(leaf.placements)}:{STATE_AXIS}@{ranks}")
    return first if not parts else first + "|" + ";".join(parts)


def metric_placement_token(metric: Any) -> str:
    """The placement part of a metric's step key: "" until one of its states is placed,
    then its placed states' layouts (strings made at placement, so the per-step key
    build reads no tensor)."""
    layouts = metric.__dict__.get(LAYOUT_ATTR) if _ever_placed else None
    if not layouts:
        return ""
    return ";".join(f"{name}={layout.token}" for name, layout in layouts.items() if is_sharded(metric.__dict__.get(name)))


def shard_report() -> Dict[str, Any]:
    """Process-wide sharding facts for telemetry."""
    mesh = metric_mesh()
    return {
        "active": mesh is not None,
        "axis_size": axis_size(),
        "data_axis_size": data_axis_size(),
        "devices": [] if mesh is None else [int(d) for d in mesh.devices.flat],
        "shard_states": _STATS.shard_states,
        "shard_degrades": _STATS.shard_degrades,
        "partition_rules": len(_partition_rules),
    }
