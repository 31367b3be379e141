"""The two-sweep (GPipe) pipeline schedule over the pp group (counterpart
of ``apex_tpu/transformer/pipeline_parallel/schedules/
fwd_bwd_pipelining_without_interleaving.py``).

The JAX schedule is one differentiable scan over ``n_micro + pp - 1``
ticks (every stage runs its block and ``ppermute``s the result on); its
transpose is the backward, a second sweep in reverse.  The port runs the
same two sweeps explicitly (:func:`~.common.run_pipeline` with
``overlap=False``): every forward, each stage sending its output on,
then every backward, the cotangents going back.  Peak activation memory
is ``n_micro`` units a stage (GPipe's); with ``checkpoint_stages`` (the
default, JAX's ``jax.checkpoint`` of the stage) a stage keeps only its
inputs and recomputes in the backward.  The memory-bounded 1F1B is
:mod:`.fwd_bwd_1f1b`.

``tensor_shape`` / ``dtype`` give the wire (the reference's arguments;
the JAX package infers them under ``jit``), needed from pp 2.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    pipelined,
)

__all__ = ["forward_backward_pipelining_without_interleaving",
           "pipeline_loss"]


def pipeline_loss(spec: PipelineStageSpec, batches: Any, *, group=None,
                  tensor_shape=None, dtype=None) -> torch.Tensor:
    """The mean microbatch loss of the whole pipeline, forward only (no
    graph is kept), the same on every stage."""
    return forward_backward_pipelining_without_interleaving(
        spec, batches, forward_only=True, group=group,
        tensor_shape=tensor_shape, dtype=dtype)[0]


def forward_backward_pipelining_without_interleaving(
    spec: PipelineStageSpec,
    batches: Any,
    *,
    forward_only: bool = False,
    group=None,
    checkpoint_stages: bool = True,
    grad_scaler=None,
    scaler_state=None,
    tensor_shape=None,
    dtype=None,
    disable_autocast: bool = False,
    deallocate_pipeline_outputs: bool = False,
    stats: Optional[dict] = None,
):
    """Returns ``(mean loss on every stage, {name: .grad} or None)``.

    ``spec`` is this rank's stage; ``batches`` the microbatches, leading
    dim ``[n_micro]``, the same on every stage (each stage reads the
    parts it needs).  With ``grad_scaler`` the loss cotangent is
    ``scale / n_micro`` and the gradients come back *scaled*; the loss
    is the unscaled mean.  ``disable_autocast`` and
    ``deallocate_pipeline_outputs`` are accepted for the reference's
    signature; ``stats`` as in :func:`~.common.run_pipeline`."""
    del disable_autocast, deallocate_pipeline_outputs
    return pipelined(
        [spec], batches, overlap=False, recompute=checkpoint_stages,
        forward_only=forward_only, group=group, grad_scaler=grad_scaler,
        scaler_state=scaler_state, tensor_shape=tensor_shape, dtype=dtype,
        stats=stats)
