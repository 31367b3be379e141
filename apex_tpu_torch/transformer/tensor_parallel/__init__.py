"""Tensor-parallel primitives over ``torch.distributed`` (counterpart of
``apex_tpu.transformer.tensor_parallel``).  ``random``, ``data`` and
``memory`` come with the tensor-parallel training slice."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
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
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    split_tensor_along_last_dim,
)

__all__ = [
    "vocab_parallel_cross_entropy",
    "ColumnParallelLinear",
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
]
