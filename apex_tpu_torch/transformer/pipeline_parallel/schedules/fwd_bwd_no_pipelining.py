"""No-pipelining schedule: the microbatches one after another, gradients
summed (counterpart of ``apex_tpu/transformer/pipeline_parallel/
schedules/fwd_bwd_no_pipelining.py``, apex's
``forward_backward_no_pipelining``).

Each microbatch's forward and backward run before the next one's; the
gradients are summed over the microbatches in fp32, as the JAX scan sums
them into fp32 zeros (``:80``), still scaled when a scaler is given.
The fp32 sums are what the function returns and what ``found_inf``
checks, as JAX returns and checks them: a sum past the half range
(65504 in fp16) whose every microbatch's part is in range is finite
here, as it is there.  Each parameter's ``.grad`` holds the sum cast to
the parameter's dtype (PyTorch keeps a gradient in its parameter's
dtype), so a caller steps from the returned sums
(``FusedOptimizer.step(grads=)``, keyed by :func:`~.common.grads_by_param`),
never from a ``.grad`` that the cast may have overflowed.  The
data-parallel reduction is the caller's, once on the sums (the
reference's deferred ``no_sync``).

``loss_fn`` is a callable ``loss_fn(microbatch) -> scalar`` over the
parameters of ``model`` (JAX's ``loss_fn(params, microbatch)``: the port's
modules hold their parameters), or a
:class:`~.common.PipelineStageSpec`, whose loss is ``last(stage(first(
mb)), mb)`` over its own parameters.  A spec's microbatch losses are
seeded with ``1 / n_micro``, as the pipelined schedules seed them, so
that this schedule stands in for them at pp 1
(``get_forward_backward_func(None, 1)``): its gradients are those of the
mean loss.  A callable's are JAX's, the sum of each microbatch loss's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch
from torch import nn

from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
    PipelineStageSpec,
    accumulated_found_inf,
    index_microbatch,
    loss_seed,
    num_microbatches,
)

__all__ = ["forward_backward_no_pipelining"]


def forward_backward_no_pipelining(
    loss_fn: Union[Callable[[Any], torch.Tensor], PipelineStageSpec],
    microbatches: Any,
    *,
    model: Optional[Any] = None,
    forward_only: bool = False,
    grad_scaler=None,
    scaler_state=None,
    with_found_inf: bool = False,
    # accepted so that every schedule takes the same keywords
    group=None,
    tensor_shape=None,
    dtype=None,
):
    """Returns ``(mean_loss, grads or None)``, with ``with_found_inf``
    ``(mean_loss, grads, found_inf)``: the step-level overflow flag, one
    check of the summed gradients (all or nothing for the step, see
    :func:`~.common.accumulated_found_inf`).

    ``microbatches``: tensors (or dicts / lists of them) with a leading
    ``[n_micro]`` dim.  ``grads`` is ``{name: fp32 sum}`` over ``model``'s
    named parameters (the spec's for a spec), None for a parameter no
    microbatch reached; each ``.grad`` is its sum in the parameter's
    dtype.  ``group``,
    ``tensor_shape`` and ``dtype`` are ignored (there is no wire)."""
    del group, tensor_shape, dtype
    spec = loss_fn if isinstance(loss_fn, PipelineStageSpec) else None
    if spec is not None:
        model = spec if model is None else model

        def loss_of(mb):
            return spec.last(spec.stage(spec.first(mb)), mb)
    else:
        loss_of = loss_fn
    n_micro = num_microbatches(microbatches)
    if model is None:
        raise ValueError("forward_backward_no_pipelining(loss_fn, ...) needs "
                         "model= (the module or spec whose parameters "
                         "loss_fn reads)")
    named = (list(model.named_parameters())
             if isinstance(model, (nn.Module, PipelineStageSpec))
             else [(str(i), p) for i, p in enumerate(model)])
    if forward_only:
        with torch.no_grad():
            total = sum(loss_of(index_microbatch(microbatches, i)).float()
                        for i in range(n_micro))
        if with_found_inf:
            return total / n_micro, None, torch.zeros(
                (), dtype=torch.bool, device=total.device)
        return total / n_micro, None

    if spec is not None:
        seed = loss_seed(grad_scaler, scaler_state, n_micro)
    elif grad_scaler is not None:
        seed = scaler_state.scale
    else:
        seed = 1.0
    params = [p for _, p in named]
    sums = [None] * len(params)
    total = None
    for i in range(n_micro):
        loss = loss_of(index_microbatch(microbatches, i))
        total = loss.detach().float() + (0 if total is None else total)
        grads = torch.autograd.grad(
            loss, params, torch.as_tensor(seed, dtype=loss.dtype,
                                          device=loss.device),
            allow_unused=True)
        if i == 0:
            sums = [None if g is None else g.float() for g in grads]
            continue
        for j, g in enumerate(grads):
            if g is not None and sums[j] is None:
                sums[j] = torch.zeros_like(g, dtype=torch.float32)
        # one fused add over the sums (a half gradient adds into its fp32
        # sum), not a Python loop of adds
        both = [(s, g) for s, g in zip(sums, grads) if g is not None]
        torch._foreach_add_([s for s, _ in both], [g for _, g in both])
    for p, g in zip(params, sums):
        p.grad = None if g is None else g.to(p.dtype)
    grads = {name: g for (name, _), g in zip(named, sums)}
    loss = total / n_micro
    if with_found_inf:
        # the fp32 sums, before any cast (JAX's check of its fp32 scan)
        return loss, grads, accumulated_found_inf(
            [g for g in sums if g is not None])
    return loss, grads
