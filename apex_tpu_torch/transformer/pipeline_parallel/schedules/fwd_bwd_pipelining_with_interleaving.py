"""Interleaved (virtual-stage) pipelining, two sweeps (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_with_interleaving.py``; apex's
``_forward_backward_pipelining_with_interleaving``, ``:27-560``).

Each rank holds ``vpp`` model chunks: global stage ``s`` is on rank ``s %
pp`` as chunk ``s // pp``.  The wire is a ring: rank ``pp - 1``'s output
of chunk ``v`` goes to rank 0's chunk ``v + 1``.  The JAX schedule
differentiates one circular scan; the port runs every forward, then
every backward, over the grouped virtual stream of
:func:`~.common.run_pipeline` (``overlap=False``), keeping each unit's
graph, or with ``checkpoint_stages`` (the default) its input only.  The
memory-bounded form is :mod:`.fwd_bwd_1f1b_interleaved`.

``spec`` is the rank's list of ``vpp`` :class:`~.common.
PipelineStageSpec` chunks (``build_model`` with a virtual pipeline
returns it), where JAX stacks the chunks' parameters ``[vpp, ...]``.
"""

from __future__ import annotations

from typing import Any, List, Optional

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    pipelined,
)

__all__ = ["forward_backward_pipelining_with_interleaving"]


def chunks_of(spec, num_model_chunks: int) -> List[PipelineStageSpec]:
    chunks = list(spec)
    if len(chunks) != num_model_chunks:
        raise ValueError(f"num_model_chunks={num_model_chunks} but "
                         f"{len(chunks)} chunk specs were given")
    return chunks


def forward_backward_pipelining_with_interleaving(
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
    None)``."""
    return pipelined(
        chunks_of(spec, num_model_chunks), batches, overlap=False,
        recompute=checkpoint_stages, forward_only=forward_only, group=group,
        grad_scaler=grad_scaler, scaler_state=scaler_state,
        tensor_shape=tensor_shape, dtype=dtype, stats=stats)
