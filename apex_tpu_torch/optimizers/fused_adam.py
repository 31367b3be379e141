"""FusedAdam: Adam / AdamW with the JAX ``FusedAdam`` semantics, as a
``torch.optim.Optimizer``.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``, with the original
apex API (``FusedAdam(params, lr=..., ...)``, ``opt.step()``).  For each
parameter with a gradient, in fp32 whatever the stored dtypes:

    g = g + wd * p                      (adam_w_mode=False: L2 into g)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    u = (m / bc1) / (sqrt(v / bc2) + eps)
    u = u + wd * p                      (adam_w_mode=True: decoupled)
    p = p - lr * u

with ``bc1, bc2 = 1 - b1**step, 1 - b2**step`` (1 without
``bias_correction``) from the group's step counter on the device; ``p`` is
stored back in its own dtype and ``m`` and ``v`` in ``state_dtype`` (bf16
moments halve the state and its traffic).  The update is a memory-bound
pass over every parameter: on CUDA one launch of the multi-tensor kernel
``mt_adam`` (:func:`apex_tpu_torch.ops.multi_tensor.adam`) over every
tensor of a group, which reads each gradient in place (multiplied by ``1 /
grad_scale`` on the device), updates the target, m and v and, with
``master_weights``, writes the new master into the half parameter in the
same pass; on the CPU its plain version, a parameter at a time with as few
fp32 passes as plain PyTorch allows (``mul``/``add_``, ``addcmul_`` for
``v`` and one ``addcdiv`` for ``p - lr u``, AdamW's decay as ``p (1 - lr
wd)`` first, ``bc1`` folded into the denominator), which the kernel follows
term for term.  That regroups the JAX function's roundings, so the two
agree to fp32 rounding, not bit for bit.

The step is :class:`~apex_tpu_torch.optimizers._common.FusedOptimizer`'s:
``master_weights=True`` keeps an fp32 master of each parameter
(``state["master_param"]``) that the update runs on, copied into the
parameter by the same pass; ``step(grad_scale=, found_inf=)`` unscales the
gradients and, where ``found_inf`` is true, keeps every value and the step
counter as they were, on the device (the kernel's ``noop``: it returns
before any load).  Unlike the JAX optimizer, which returns new arrays, this
one updates the parameters and its state (``exp_avg``, ``exp_avg_sq``,
``step``, ``master_param``) in place.  ``amsgrad=True`` raises as the JAX
class does.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops import multi_tensor as mt
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer,
    bias_corrections,
    inv_scale,
)

__all__ = ["FusedAdam"]


class FusedAdam(FusedOptimizer):
    def __init__(self, params, lr: float = 1e-3, bias_correction: bool = True,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, master_weights: bool = False,
                 state_dtype: torch.dtype = torch.float32):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults, master_weights=master_weights)
        self.adam_w_mode = adam_w_mode
        self.state_dtype = state_dtype

    def _update(self, work, skip, grad_scale) -> None:
        for group, params, grads, targets in work:
            b1, b2 = group["betas"]
            step = self._group_step(params)
            for p in params:
                state = self.state[p]
                if "exp_avg" not in state:
                    state["step"] = step
                    state["exp_avg"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=self.state_dtype,
                        memory_format=torch.preserve_format)
            nxt = self._advance(step, skip)
            bc1, bc2 = (bias_corrections(nxt, b1, b2)
                        if group["bias_correction"] else (None, None))
            mt.adam(grads, targets, [self.state[p]["exp_avg"] for p in params],
                    [self.state[p]["exp_avg_sq"] for p in params],
                    mode=mt.ADAMW if self.adam_w_mode else mt.ADAM_L2,
                    lr=group["lr"], beta1=b1, beta2=b2, eps=group["eps"],
                    weight_decay=group["weight_decay"],
                    inv_scale=inv_scale(grad_scale, params[0].device),
                    bc1=bc1, bc2=bc2, noop=skip,
                    copy=params if self.master_weights else None)
