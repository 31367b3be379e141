"""Memory-bounded interleaved (virtual-stage) 1F1B schedule (counterpart
of ``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_1f1b_interleaved.py``).

JAX's grouped virtual stream (``:15-21``, ``:157``): with ``S = vpp * pp``
global stages, at tick ``t`` rank ``r`` forwards unit ``kf = t - r`` and
backwards unit ``kb = t - (pp - 1 - r) - (S - 1)``; unit ``k`` is
microbatch ``(k // (pp * vpp)) * pp + k % pp`` through chunk ``(k // pp)
% vpp`` (reversed for the backward), so each rank runs ``pp``
microbatches of chunk 0, then ``pp`` of chunk 1, and so on.  Both wires
are rings.  The forward banks each stage input in a ``2 S - 1``-slot
bank and the backward recomputes the chunk from it, as
:mod:`.fwd_bwd_1f1b` does: memory is flat in the number of microbatches.
See :func:`~.common.run_pipeline`.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    pipelined,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules.fwd_bwd_pipelining_with_interleaving import (  # noqa: E501
    chunks_of,
)

__all__ = ["forward_backward_pipelining_1f1b_interleaved"]


def forward_backward_pipelining_1f1b_interleaved(
    spec: List[PipelineStageSpec],
    batches: Any,
    *,
    num_model_chunks: int,
    forward_only: bool = False,
    group=None,
    checkpoint_stages: bool = True,
    grad_scaler=None,
    scaler_state=None,
    tensor_shape=None,
    dtype=None,
    stats: Optional[dict] = None,
):
    """Returns ``(mean loss on every stage, [{name: .grad}] a chunk, or
    None)``.  Stage recompute is always on, as in
    :func:`~.fwd_bwd_1f1b.forward_backward_pipelining_1f1b`."""
    if not checkpoint_stages:
        warnings.warn(
            "forward_backward_pipelining_1f1b_interleaved always recomputes "
            "stages from banked inputs (the memory bound depends on it); "
            "checkpoint_stages=False is ignored.", stacklevel=2)
    return pipelined(
        chunks_of(spec, num_model_chunks), batches, overlap=True,
        recompute=True, forward_only=forward_only, group=group,
        grad_scaler=grad_scaler, scaler_state=scaler_state,
        tensor_shape=tensor_shape, dtype=dtype, stats=stats)
