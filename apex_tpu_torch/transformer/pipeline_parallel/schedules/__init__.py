"""Pipeline schedules (counterpart of
``apex_tpu.transformer.pipeline_parallel.schedules``)."""

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    accumulated_found_inf,
    build_model,
    grads_by_param,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_1f1b import (
    forward_backward_pipelining_1f1b,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_1f1b_interleaved import (  # noqa: E501
    forward_backward_pipelining_1f1b_interleaved,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_no_pipelining import (  # noqa: E501
    forward_backward_no_pipelining,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_with_interleaving import (  # noqa: E501
    forward_backward_pipelining_with_interleaving,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_without_interleaving import (  # noqa: E501
    forward_backward_pipelining_without_interleaving,
    pipeline_loss,
)

__all__ = [
    "PipelineStageSpec",
    "accumulated_found_inf",
    "build_model",
    "grads_by_param",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_1f1b",
    "forward_backward_pipelining_1f1b_interleaved",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "pipeline_loss",
    "get_forward_backward_func",
]


def get_forward_backward_func(virtual_pipeline_model_parallel_size,
                              pipeline_model_parallel_size):
    """schedules/__init__.py get_forward_backward_func parity: the 1F1B
    schedules at pp > 1 (interleaved with a virtual pipeline), else
    :func:`forward_backward_no_pipelining`.  The two-sweep schedules stay
    callable directly."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_1f1b_interleaved
        return forward_backward_pipelining_1f1b
    return forward_backward_no_pipelining
