"""Tensor-parallel primitives over ``torch.distributed`` (counterpart of
``apex_tpu.transformer.tensor_parallel``): the mappings, the parallel
layers, the vocab-parallel cross entropy, the RNG streams and
``checkpoint``, the batch broadcast and the memory buffers."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import (
    broadcast_data,
    tp_replicated_rows,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    all_reduce_gradients,
    allreduce_expert_replicated_grads,
    allreduce_sequence_parallel_grads,
    RowParallelLinear,
    VocabParallelEmbedding,
    parallel_lm_logits,
    shard_init,
    tp_world_size,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    override_forward_allreduce,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    tensor_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.memory import (
    MemoryBuffer,
    RingMemBuffer,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    CudaRNGStatesTracker,
    RNGStatesTracker,
    checkpoint,
    get_rng_state_tracker,
    model_parallel_cuda_manual_seed,
    model_parallel_seed,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

__all__ = [
    "vocab_parallel_cross_entropy",
    "ColumnParallelLinear",
    "allreduce_expert_replicated_grads",
    "allreduce_sequence_parallel_grads",
    "all_reduce_gradients",
    "parallel_lm_logits",
    "shard_init",
    "tp_world_size",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "override_forward_allreduce",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "tensor_parallel_region",
    "VocabUtility",
    "divide",
    "split_tensor_along_last_dim",
    "broadcast_data",
    "tp_replicated_rows",
    "MemoryBuffer",
    "RingMemBuffer",
    "RNGStatesTracker",
    "CudaRNGStatesTracker",
    "get_rng_state_tracker",
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",
    "checkpoint",
]
