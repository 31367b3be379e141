"""True 1F1B pipeline schedule with memory bounded in the number of
stages (counterpart of ``apex_tpu/transformer/pipeline_parallel/
schedules/fwd_bwd_1f1b.py``; apex's
``forward_backward_pipelining_without_interleaving``, ``:241-520``).

JAX's timetable (``fwd_bwd_1f1b.py:137-138``): over ``n_micro + 2 (pp -
1)`` ticks rank ``r`` forwards microbatch ``t - r`` and backwards
microbatch ``t - 2 (pp - 1) + r``, so the last stage backwards a
microbatch in the tick it forwards it.  The forward runs under
``no_grad`` and banks the stage input in ``2 pp - 1`` slots; the
backward recomputes the stage from that input and back-propagates
through it, the whole-stage recompute the memory bound rests on (JAX's
in-tick ``jax.vjp``).  Inactive ticks compute nothing (JAX computes and
masks them; the numbers are the same).  See
:func:`~.common.run_pipeline`.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    pipelined,
)

__all__ = ["forward_backward_pipelining_1f1b"]


def forward_backward_pipelining_1f1b(
    spec: PipelineStageSpec,
    batches: Any,
    *,
    forward_only: bool = False,
    group=None,
    grad_scaler=None,
    scaler_state=None,
    checkpoint_stages: bool = True,
    tensor_shape=None,
    dtype=None,
    disable_autocast: bool = False,
    deallocate_pipeline_outputs: bool = False,
    stats: Optional[dict] = None,
):
    """Returns ``(mean loss on every stage, {name: .grad} or None)``, the
    numbers of :func:`~.fwd_bwd_pipelining_without_interleaving.
    forward_backward_pipelining_without_interleaving` with a 1F1B memory
    profile.  Gradients accumulate in ``.grad`` in the parameters' dtype
    and come back scaled when a scaler is given.

    Stage recompute is always on: ``checkpoint_stages=False`` warns and
    is ignored, as in the JAX package."""
    if not checkpoint_stages:
        warnings.warn(
            "forward_backward_pipelining_1f1b always recomputes stages from "
            "banked inputs (the memory bound depends on it); "
            "checkpoint_stages=False is ignored.  Use the two-sweep "
            "forward_backward_pipelining_without_interleaving schedule for "
            "a no-recompute backward.", stacklevel=2)
    del disable_autocast, deallocate_pipeline_outputs
    return pipelined(
        [spec], batches, overlap=True, recompute=True,
        forward_only=forward_only, group=group, grad_scaler=grad_scaler,
        scaler_state=scaler_state, tensor_shape=tensor_shape, dtype=dtype,
        stats=stats)
