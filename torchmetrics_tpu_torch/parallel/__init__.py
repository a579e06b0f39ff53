"""Cross-process synchronization of metric states, bounded, and elastic snapshots.

``sync`` gathers states over ``torch.distributed``; ``packing`` lays a whole metric or
collection out as one collective per buffer; ``resilience`` bounds every collective
(deadline, retries, typed errors), ``faults`` plants deterministic faults at that
boundary, and ``elastic`` saves and restores states across world sizes. ``sharding``
places states over a rank mesh; its names are exported lazily, as in the JAX package
(the engines import this package while ``sharding`` reads the engine's counters).
"""

from torchmetrics_tpu_torch.parallel.elastic import (
    ContinuousSnapshotter,
    SnapshotIntegrityError,
    SnapshotPolicy,
    SnapshotReshardError,
    SnapshotVersionError,
    restore_latest,
    restore_resharded,
    save_state_shard,
    state_fingerprint,
)
from torchmetrics_tpu_torch.parallel.faults import (
    CollectiveTimeout,
    CorruptPayload,
    DelayRank,
    RankDrop,
    fault_context,
)
from torchmetrics_tpu_torch.parallel.packing import PackedSyncPlan, PackingError
from torchmetrics_tpu_torch.parallel.resilience import (
    CollectiveTimeoutError,
    PayloadCorruptError,
    RankUnreachableError,
    SyncFaultError,
    resilience_context,
    resilience_snapshot,
)
from torchmetrics_tpu_torch.parallel.sync import (
    EvalMesh,
    axis_gather,
    axis_max,
    axis_mean,
    axis_min,
    axis_sum,
    distributed_available,
    gather_all_tensors,
    jit_distributed_available,
)

_SHARDING_EXPORTS = (
    "axis_size",
    "build_mesh",
    "data_axis_size",
    "ensure_multihost",
    "is_sharded",
    "mesh_context",
    "metric_mesh",
    "partition_rules_context",
    "reshard_states",
    "set_mesh",
    "set_partition_rules",
    "shard_batch",
    "sharding_enabled",
)


def __getattr__(name: str):
    if name in _SHARDING_EXPORTS:
        import importlib

        return getattr(importlib.import_module("torchmetrics_tpu_torch.parallel.sharding"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CollectiveTimeout",
    "CollectiveTimeoutError",
    "ContinuousSnapshotter",
    "CorruptPayload",
    "DelayRank",
    "EvalMesh",
    "PackedSyncPlan",
    "PackingError",
    "PayloadCorruptError",
    "RankDrop",
    "RankUnreachableError",
    "SnapshotIntegrityError",
    "SnapshotPolicy",
    "SnapshotReshardError",
    "SnapshotVersionError",
    "SyncFaultError",
    "axis_gather",
    "axis_max",
    "axis_mean",
    "axis_min",
    "axis_size",
    "axis_sum",
    "build_mesh",
    "data_axis_size",
    "distributed_available",
    "ensure_multihost",
    "fault_context",
    "gather_all_tensors",
    "is_sharded",
    "jit_distributed_available",
    "mesh_context",
    "metric_mesh",
    "partition_rules_context",
    "reshard_states",
    "resilience_context",
    "resilience_snapshot",
    "restore_latest",
    "restore_resharded",
    "save_state_shard",
    "set_mesh",
    "set_partition_rules",
    "shard_batch",
    "sharding_enabled",
    "state_fingerprint",
]
