"""Hot-loop transfer guard: prove (or log) the zero-host-transfer invariant (counterpart of
``torchmetrics_tpu/diag/transfer_guard.py``).

- :func:`transfer_guard` runs a section in ``"strict"`` mode (an observed device-to-host
  readback raises :class:`TransferGuardError` and is recorded as ``transfer.blocked``)
  or ``"log"`` mode (readbacks are recorded as ``transfer.host`` events and go through).
- :func:`transfer_allowed` marks a *sanctioned* boundary inside a guarded section: the
  packed-sync metadata gather and backbone collectives, the sampled probes, the epoch-end
  sentinel and quarantine reads. Every label is declared in :data:`TRANSFER_LABELS`
  (the JAX registry, unchanged) or starts with one of ``TRANSFER_LABEL_PREFIXES``.

Two detection layers, both installed for the guarded scope only:

1. **The native layer**: ``torch.cuda.set_sync_debug_mode("error" | "warn")`` while a
   guard is active, on a machine with CUDA. It sees every operation that synchronizes the
   host with the card (a device-to-host copy, ``.item()``, a stream synchronize), however
   reached, but not a ``non_blocking`` copy into pinned memory, which does not
   synchronize. In strict mode the runtime's error is re-raised as
   ``TransferGuardError``; in log mode its warnings are caught and recorded as
   ``transfer.host`` events with ``op="cuda-sync"``.
2. **The Python layer**, so the invariant is testable on the CPU: scoped wrappers on the
   points where a tensor becomes a host value (``Tensor.item``, ``tolist``, ``numpy``,
   ``__array__``, ``cpu``, ``to`` with a CPU target, ``__float__``, ``__int__``,
   ``__bool__``) and on ``numpy.asarray`` / ``numpy.array``. Like the JAX layer, which
   counts any ``jax.Array``, it counts a tensor on any device.

The hooks are refcounted and removed on exit, so unguarded code pays nothing.

**Threads.** The mode lives in a context variable, as in the JAX package, so the Python
layer covers the guarded thread (and code run in a copy of its context). The native mode
is global to the process: while a guard is active it covers every thread (the async
drain worker, the collective watchdog thread of ``parallel/resilience.py``, gloo's own
threads), and a sanctioned boundary lowers it for the whole process until the last open
boundary closes (refcounted), so a sanctioned collective running on the watchdog thread
does not trip strict mode while its caller waits inside ``transfer_allowed``.
:func:`native_reentry` keeps the JAX name; here the native mode needs no re-arming on a
worker thread.
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Generator, List

from torchmetrics_tpu_torch.diag import trace

__all__ = [
    "TRANSFER_LABELS",
    "TRANSFER_LABEL_PREFIXES",
    "TransferGuardError",
    "native_reentry",
    "transfer_allowed",
    "transfer_guard",
]

_MODES = ("strict", "log")

#: The registry of SANCTIONED host-transfer boundary labels (the JAX package's, label
#: for label). Every ``transfer_allowed("<label>")`` call names one of these or starts
#: with one of ``TRANSFER_LABEL_PREFIXES``.
TRANSFER_LABELS = frozenset({
    # packed-sync backbone (parallel/packing.py, engine/epoch.py)
    "sync-metadata",   # the one metadata gather covering every dynamic state
    "sync-audit",      # divergence-audit fingerprint reads on the metadata path
    "sync-fault",      # classified-fault payload inspection (parallel/resilience.py)
    # engine evidence boundaries (engine/, diag/)
    "profile-probe",   # sampled completion probes
    "drift-probe",     # sampled compensated-drift audit reads
    "quarantine-check",  # =error admission precheck before any mutation
    "quarantine-read",   # sanctioned epoch-end quarantine-counter flush
    "sentinel-setup",  # one-time Inf-default detection at sentinel install
    "sentinel-read",   # sanctioned sentinel bitmask read
    "group-discovery",  # one-time compute-group value comparison (collections.py)
    # checkpoint/restore boundaries (parallel/elastic.py)
    "snapshot-save",   # state materialization into an atomic .npz shard
    "snapshot-load",   # shard payload reads on the restore/reshard path
    # fault injection (parallel/faults.py): corrupts an already-gathered row
    "fault-inject",
    # serving boundaries (serve/)
    "serve-setup",     # one-time capture of nested-metric defaults
    "serve-scrape",    # scrape-path host reads with the snapshot retry protocol
    "federation-ingest",  # pod-snapshot envelope (de)serialization at the aggregation tier
    # heavy-workload retained host paths: counted fallbacks, declared
    "fid-host-eigh",   # FID Fréchet on host LAPACK
    "fid-sample-guard",  # FID's epoch-boundary <2-sample check (two scalar reads)
    "map-host-matcher",  # mAP list/RLE host evaluator's one batched epoch-end fetch
})

#: label PREFIXES sanctioned with a dynamic suffix: the collective backbone labels every
#: buffer exchange ``collective:<role>:<dtype>`` at runtime
TRANSFER_LABEL_PREFIXES = ("collective:",)

#: the text of the CUDA runtime's sync-debug error and warning
_NATIVE_TEXT = "synchronizing CUDA operation"


class TransferGuardError(RuntimeError):
    """A device->host readback happened inside a strict transfer-guard scope."""


_MODE_VAR: "ContextVar[str]" = ContextVar("tm_tpu_torch_transfer_guard_mode", default="off")
_ALLOW_VAR: "ContextVar[int]" = ContextVar("tm_tpu_torch_transfer_allow_depth", default=0)

# Python-layer hook refcount and saved originals (installation is process-global,
# activation is context-scoped)
_install_depth = 0
_saved: dict = {}
_MISSING = object()

# native layer: the modes of the open guard scopes and the open sanctioned boundaries,
# process-wide (the CUDA sync-debug mode is global)
_native_lock = threading.Lock()
_native_modes: List[str] = []
_native_allow = 0
_native_base: Any = None


def _observe(op: str) -> None:
    """Handle one Python-layer readback under the active mode."""
    mode = _MODE_VAR.get()
    if mode == "off" or _ALLOW_VAR.get() > 0:
        return
    if mode == "log":
        trace.record("transfer.host", "", op=op, layer="python")
        return
    trace.record("transfer.blocked", "", op=op, layer="python")
    raise TransferGuardError(
        f"device->host readback via {op!r} inside a strict transfer-guard scope."
        " The metric hot loop must not fetch device values; move the readback"
        " to the epoch boundary, or wrap a sanctioned collective/export point"
        " in torchmetrics_tpu_torch.diag.transfer_allowed()."
    )


_TENSOR_METHODS = ("item", "tolist", "numpy", "__array__", "cpu", "__float__", "__int__", "__bool__")


def _targets_cpu(args: tuple, kwargs: dict) -> bool:
    """Whether a ``Tensor.to`` call names a CPU destination."""
    import torch

    dest = kwargs.get("device")
    if dest is None and args:
        first = args[0]
        if isinstance(first, torch.Tensor):
            dest = first.device
        elif isinstance(first, (str, torch.device)):
            dest = first
    if dest is None or isinstance(dest, int):
        return False
    try:
        return torch.device(dest).type == "cpu"
    except (RuntimeError, TypeError):
        return False


def _install_hooks() -> None:
    """Wrap the host-readback entry points (refcounted; idempotent)."""
    global _install_depth
    _install_depth += 1
    if _install_depth > 1:
        return
    import numpy as np
    import torch

    cls = torch.Tensor
    for name in (*_TENSOR_METHODS, "to"):
        _saved[name] = cls.__dict__.get(name, _MISSING)

    def wrap(name: str, orig: Any) -> Any:
        def guarded(self, *args: Any, **kwargs: Any):  # noqa: ANN001 -- a method
            _observe(f"Tensor.{name}")
            return orig(self, *args, **kwargs)

        guarded.__name__ = name
        return guarded

    for name in _TENSOR_METHODS:
        setattr(cls, name, wrap(name, getattr(cls, name)))

    orig_to = cls.to

    def guarded_to(self, *args: Any, **kwargs: Any):  # noqa: ANN001 -- a method
        if _targets_cpu(args, kwargs):
            _observe("Tensor.to(cpu)")
        return orig_to(self, *args, **kwargs)

    cls.to = guarded_to
    orig_asarray, orig_nparray = np.asarray, np.array
    _saved["np.asarray"], _saved["np.array"] = orig_asarray, orig_nparray

    # signature-transparent: numpy's first parameters are legally keyword
    def guarded_asarray(*args: Any, **kwargs: Any):
        if isinstance(args[0] if args else kwargs.get("a"), torch.Tensor):
            _observe("np.asarray")
        return orig_asarray(*args, **kwargs)

    def guarded_nparray(*args: Any, **kwargs: Any):
        if isinstance(args[0] if args else kwargs.get("object"), torch.Tensor):
            _observe("np.array")
        return orig_nparray(*args, **kwargs)

    np.asarray = guarded_asarray
    np.array = guarded_nparray


def _uninstall_hooks() -> None:
    global _install_depth
    _install_depth -= 1
    if _install_depth > 0:
        return
    import numpy as np
    import torch

    cls = torch.Tensor
    for name in (*_TENSOR_METHODS, "to"):
        orig = _saved.pop(name)
        if orig is _MISSING:
            delattr(cls, name)
        else:
            setattr(cls, name, orig)
    np.asarray = _saved.pop("np.asarray")
    np.array = _saved.pop("np.array")


def hooks_installed() -> bool:
    """Whether the Python-layer wrappers are in place (tests check they leave)."""
    return _install_depth > 0


# ------------------------------------------------------------------ native layer


def _native_available() -> bool:
    import torch

    return torch.cuda.is_available()


def _native_apply() -> None:
    """Set the process's sync-debug mode from the open scopes (``_native_lock`` held)."""
    import torch

    if not _native_modes or _native_allow > 0:
        torch.cuda.set_sync_debug_mode(_native_base)
    else:
        torch.cuda.set_sync_debug_mode("error" if "strict" in _native_modes else "warn")


@contextmanager
def _native_guard(mode: str) -> Generator[None, None, None]:
    global _native_base
    if not _native_available():
        yield
        return
    import torch

    with _native_lock:
        if not _native_modes:
            _native_base = torch.cuda.get_sync_debug_mode()
        _native_modes.append(mode)
        _native_apply()
    try:
        yield
    finally:
        with _native_lock:
            _native_modes.remove(mode)
            _native_apply()


@contextmanager
def _native_lowered() -> Generator[None, None, None]:
    """Lower the native mode for a sanctioned boundary while any guard is open."""
    global _native_allow
    with _native_lock:
        active = bool(_native_modes)
        if active:
            _native_allow += 1
            _native_apply()
    try:
        yield
    finally:
        if active:
            with _native_lock:
                _native_allow -= 1
                _native_apply()


def _record_native_warnings(caught: list) -> None:
    """Log mode: the sync-debug warnings become ``transfer.host`` events; other warnings
    are shown as they would have been."""
    for w in caught:
        if _NATIVE_TEXT in str(w.message):
            trace.record("transfer.host", "", op="cuda-sync", layer="native")
        else:
            warnings.showwarning(w.message, w.category, w.filename, w.lineno)


@contextmanager
def transfer_guard(mode: str = "strict") -> Generator[None, None, None]:
    """Run a section with device->host readbacks disallowed (or logged).

    Args:
        mode: ``"strict"``: any readback raises :class:`TransferGuardError` (and is
            recorded as a ``transfer.blocked`` event); ``"log"``: readbacks are recorded
            as ``transfer.host`` events and allowed through.
    """
    if mode not in _MODES:
        raise ValueError(f"transfer_guard mode must be one of {_MODES}, got {mode!r}")
    _install_hooks()
    token = _MODE_VAR.set(mode)
    try:
        if mode == "log":
            caught: list = []
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    with _native_guard(mode):
                        yield
            finally:
                # outside the recording scope: a warning shown again must not land in it
                _record_native_warnings(caught)
        else:
            try:
                with _native_guard(mode):
                    yield
            except RuntimeError as exc:
                if _NATIVE_TEXT not in str(exc) or isinstance(exc, TransferGuardError):
                    raise
                trace.record("transfer.blocked", "", op="cuda-sync", layer="native")
                raise TransferGuardError(
                    f"a synchronizing CUDA operation inside a strict transfer-guard scope ({exc})."
                    " Move the readback to the epoch boundary or wrap a sanctioned point in"
                    " torchmetrics_tpu_torch.diag.transfer_allowed()."
                ) from exc
    finally:
        _MODE_VAR.reset(token)
        _uninstall_hooks()


@contextmanager
def native_reentry() -> Generator[None, None, None]:
    """Re-arm the native guard on a worker thread from the propagated mode (the JAX
    name). The CUDA sync-debug mode is global to the process, so an open guard already
    covers every thread: this is a plain scope kept for API parity."""
    yield


@contextmanager
def transfer_allowed(label: str = "") -> Generator[None, None, None]:
    """Sanction a host-transfer boundary inside a guarded section: readbacks inside pass
    both layers without raising or logging a violation."""
    depth_token = _ALLOW_VAR.set(_ALLOW_VAR.get() + 1)
    try:
        if not _native_modes:
            yield
        else:
            with _native_lowered():
                yield
    finally:
        _ALLOW_VAR.reset(depth_token)
