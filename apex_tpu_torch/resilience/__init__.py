"""apex_tpu_torch.resilience: the port of ``apex_tpu.resilience``.

So far:

- validated atomic checkpoints of whole trees (v1:
  :mod:`~apex_tpu_torch.resilience.checkpoint`), the same files as the
  JAX package's, with the asynchronous writer of
  :mod:`~apex_tpu_torch.resilience.async_checkpoint`;
- classified retry with deterministic backoff
  (:mod:`~apex_tpu_torch.resilience.retry`);
- the supervisor's heartbeat file
  (:mod:`~apex_tpu_torch.resilience.supervisor`);
- the fault injectors of
  :mod:`~apex_tpu_torch.resilience.fault_injection`: the serving faults,
  the reload, fleet and rollout faults, and the checkpoint-writer crash.

- sharded (v2) checkpoints that restore onto any world
  (:mod:`~apex_tpu_torch.resilience.elastic`), the same files as the JAX
  package's, with the ``CorruptShardFile`` fault.

Replica consistency, the guarded step, the data guard, the rest of the
supervisor and the training faults wait for the training-side slice.
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
from apex_tpu_torch.resilience.elastic import (
    PartitionSpec,
    ShardedCheckpointManager,
    restore_sharded_checkpoint,
    save_sharded_checkpoint,
    snapshot_sharded_tree,
    validate_sharded_checkpoint,
)
from apex_tpu_torch.resilience.fault_injection import (
    CancelStorm,
    CorruptShardFile,
    CrashCheckpointWriter,
    SimulatedWriterCrash,
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
    "CrashCheckpointWriter",
    "SimulatedWriterCrash",
    "RetryExhausted",
    "RetryPolicy",
    "TransientError",
    "is_transient",
    "retry_transient",
    "read_heartbeat",
    "write_heartbeat",
    "CancelStorm",
    "SlowDecodeStep",
    "StallStream",
    "CorruptShardFile",
    "PartitionSpec",
    "ShardedCheckpointManager",
    "restore_sharded_checkpoint",
    "save_sharded_checkpoint",
    "snapshot_sharded_tree",
    "validate_sharded_checkpoint",
]
