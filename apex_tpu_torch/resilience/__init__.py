"""apex_tpu_torch.resilience: survive preemption, corruption and blow-ups
(the port of ``apex_tpu.resilience``).

- :mod:`.checkpoint` — validated atomic checkpoints of whole trees (v1),
  the JAX package's files, with keep-last-K rotation and the fallback
  to the newest checkpoint that validates; :mod:`.async_checkpoint` —
  the asynchronous writer.
- :mod:`.elastic` — sharded (v2) checkpoints that restore onto any
  world.
- :mod:`.fault_injection` — deterministic seed-driven faults: the
  serving, reload, fleet and rollout faults, the checkpoint-writer
  crash, and the training faults (NaN/Inf gradients, preemption,
  checkpoint corruption, stragglers, flaky producers, corrupt batches,
  replica divergence), each placed as JAX's for the same seed.
- :mod:`.guarded` — anomaly-aware stepping over
  :mod:`apex_tpu_torch.amp.scaler`: per-leaf non-finite localization, a
  consecutive-skip counter and bounded degradation of the loss-scale
  floor, nothing read on the device.
- :mod:`.supervisor` — the host loop over all of it: the step watchdog,
  the heartbeat file and the :class:`TrainingSupervisor` escalation
  (retry, skip budget, consistency passes, emergency checkpoint, clean
  abort).
- :mod:`.retry` — classified-exception retry with deterministic
  backoff.
- :mod:`.data_guard` — the validating batch iterator with a skip budget
  and a stall timeout.
- :mod:`.consistency` — cross-replica desync detection (JAX's leaf hash
  bit for bit) and repair, one process a replica.

``__all__`` holds the JAX package's names in its order, then the port's
own: :func:`~.guarded.fetch_metrics` (the host read that emits the
guard's floor event), ``PartitionSpec`` and the serving faults
``CancelStorm``, ``SlowDecodeStep`` and ``StallStream``.
"""

from apex_tpu_torch.resilience.async_checkpoint import (
    AsyncCheckpointer,
    SaveFuture,
    SaveVetoed,
)
from apex_tpu_torch.resilience.checkpoint import (
    CheckpointError,
    CheckpointManager,
    LeafSnapshot,
    TreeSnapshot,
    latest_valid_step,
    restore_checkpoint,
    save_checkpoint,
    snapshot_tree,
    validate_checkpoint,
)
from apex_tpu_torch.resilience.consistency import (
    DivergedLeaf,
    ReplicaConsistency,
    ReplicaDesyncError,
    collapse_replicas,
    expand_replicas,
    majority_root,
    replica_hashes,
    resync_replicas,
    verify_replicas,
)
from apex_tpu_torch.resilience.data_guard import (
    DataStallError,
    GuardedIterator,
    SkipBudgetExceeded,
    spec_of,
    validate_batch,
)
from apex_tpu_torch.resilience.elastic import (
    ShardedCheckpointManager,
    restore_sharded_checkpoint,
    save_sharded_checkpoint,
    snapshot_sharded_tree,
    validate_sharded_checkpoint,
)
from apex_tpu_torch.resilience.fault_injection import (
    CorruptBatch,
    CorruptShardFile,
    CrashCheckpointWriter,
    DesyncReplica,
    FaultInjector,
    FaultPlan,
    FlakyIterator,
    SimulatedPreemption,
    SimulatedWriterCrash,
    SlowStep,
)
from apex_tpu_torch.resilience.guarded import (
    GuardConfig,
    GuardState,
    fetch_metrics,
    guarded_update,
    init_guard_state,
    make_guarded_step,
    nonfinite_counts,
    nonfinite_report,
)
from apex_tpu_torch.resilience.elastic import PartitionSpec
from apex_tpu_torch.resilience.fault_injection import (
    CancelStorm,
    SlowDecodeStep,
    StallStream,
)

from apex_tpu_torch.resilience.retry import (
    RetryExhausted,
    RetryPolicy,
    TransientError,
    is_transient,
    retry_transient,
)
from apex_tpu_torch.resilience.supervisor import (
    StepDeadlineExceeded,
    StepWatchdog,
    SupervisorConfig,
    TrainingAborted,
    TrainingSupervisor,
    read_heartbeat,
    write_heartbeat,
)

__all__ = [
    "AsyncCheckpointer",
    "SaveFuture",
    "SaveVetoed",
    "CheckpointError",
    "CheckpointManager",
    "LeafSnapshot",
    "TreeSnapshot",
    "latest_valid_step",
    "restore_checkpoint",
    "save_checkpoint",
    "snapshot_tree",
    "validate_checkpoint",
    "CorruptBatch",
    "CorruptShardFile",
    "CrashCheckpointWriter",
    "DesyncReplica",
    "FaultInjector",
    "FaultPlan",
    "FlakyIterator",
    "SimulatedPreemption",
    "SimulatedWriterCrash",
    "SlowStep",
    "DivergedLeaf",
    "ReplicaConsistency",
    "ReplicaDesyncError",
    "collapse_replicas",
    "expand_replicas",
    "majority_root",
    "replica_hashes",
    "resync_replicas",
    "verify_replicas",
    "ShardedCheckpointManager",
    "restore_sharded_checkpoint",
    "save_sharded_checkpoint",
    "snapshot_sharded_tree",
    "validate_sharded_checkpoint",
    "GuardConfig",
    "GuardState",
    "guarded_update",
    "init_guard_state",
    "make_guarded_step",
    "nonfinite_counts",
    "nonfinite_report",
    "DataStallError",
    "GuardedIterator",
    "SkipBudgetExceeded",
    "spec_of",
    "validate_batch",
    "RetryExhausted",
    "RetryPolicy",
    "TransientError",
    "is_transient",
    "retry_transient",
    "StepDeadlineExceeded",
    "StepWatchdog",
    "SupervisorConfig",
    "TrainingAborted",
    "TrainingSupervisor",
    "read_heartbeat",
    "write_heartbeat",
    # the port's own
    "fetch_metrics",
    "PartitionSpec",
    "CancelStorm",
    "SlowDecodeStep",
    "StallStream",
]
