"""apex_tpu_torch.parallel: data parallelism over a ``torch.distributed``
process group (counterpart of ``apex_tpu/parallel/__init__.py``):
``DistributedDataParallel``, ``Reducer``, ``SyncBatchNorm`` (with
``convert_syncbn_model``) and ``LARC``.  The JAX package's collectives run
over a mesh axis; here over a process group, NCCL on the card and gloo on
the CPU.
"""

from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    allreduce_grads,
    broadcast_params,
)
from apex_tpu_torch.parallel.LARC import LARC
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    sync_batch_stats,
)

__all__ = [
    "DistributedDataParallel",
    "Reducer",
    "allreduce_grads",
    "broadcast_params",
    "LARC",
    "SyncBatchNorm",
    "convert_syncbn_model",
    "sync_batch_stats",
]
