"""Cross-process synchronization of metric states, bounded, and elastic snapshots.

``sync`` gathers states over ``torch.distributed``; ``packing`` lays a whole metric or
collection out as one collective per buffer; ``resilience`` bounds every collective
(deadline, retries, typed errors), ``faults`` plants deterministic faults at that
boundary, and ``elastic`` saves and restores states across world sizes. The JAX
package's sharding names (``parallel/sharding.py``) are not ported yet.
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
from torchmetrics_tpu_torch.parallel.sync import distributed_available, gather_all_tensors

__all__ = [
    "CollectiveTimeout",
    "CollectiveTimeoutError",
    "ContinuousSnapshotter",
    "CorruptPayload",
    "DelayRank",
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
    "distributed_available",
    "fault_context",
    "gather_all_tensors",
    "resilience_context",
    "resilience_snapshot",
    "restore_latest",
    "restore_resharded",
    "save_state_shard",
    "state_fingerprint",
]
