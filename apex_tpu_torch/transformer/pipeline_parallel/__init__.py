"""apex_tpu_torch.transformer.pipeline_parallel: pipeline schedules over
the pp process group (counterpart of
``apex_tpu.transformer.pipeline_parallel``; apex's p2p layer,
no-pipelining / 1F1B / interleaved schedules, microbatch utils, timers)."""

from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    PipelineStageSpec,
    accumulated_found_inf,
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_1f1b,
    forward_backward_pipelining_1f1b_interleaved,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    get_current_global_batch_size,
    get_micro_batch_size,
    get_num_microbatches,
    setup_microbatch_calculator,
    update_num_microbatches,
)

__all__ = [
    "PipelineStageSpec",
    "accumulated_found_inf",
    "build_model",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_1f1b",
    "forward_backward_pipelining_1f1b_interleaved",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "get_forward_backward_func",
    "get_current_global_batch_size",
    "get_micro_batch_size",
    "get_num_microbatches",
    "setup_microbatch_calculator",
    "update_num_microbatches",
]
